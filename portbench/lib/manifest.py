"""`BENCHMARK.json`: its cells, configurations and metrics, and which
metrics a cell reports."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

from .plugins import load_json


@dataclass
class Manifest:
    """The parsed `BENCHMARK.json` at ``root``, the benchmark's files under
    ``root/portbench``."""

    root: Path
    data: dict

    @classmethod
    def load(cls, root: Path) -> "Manifest":
        root = Path(root)
        return cls(root, json.loads((root / "BENCHMARK.json").read_text()))

    @property
    def folder(self) -> Path:
        return self.root / "portbench"

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{[c['name'] for c in self.data['workloads']]})")

    def config_entry(self, name: str) -> dict:
        for config in self.data["configs"]:
            if config["name"] == name:
                return config
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file, as it is run."""
        entry = self.config_entry(name)
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, name: str) -> dict:
        return load_json(self.folder / "mixes", name)

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics ``cell`` reports: every one."""
        self.cell(cell)
        return list(self.data["end_to_end"])

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics ``cell`` reports in a traced run: those
        that list it under ``workloads``."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]
