"""The harness's general parts: the manifest, plugins found by name, the
run of one cell, the device trace's reduction, the card's peaks and the
comparison that decides `correct`."""
