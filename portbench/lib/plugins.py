"""Files found by name: a configuration, a traffic mix, a metric's reader, a
program's reference and a driver each sit in a file of their own under
``portbench/``, and the harness loads them from the names in
`BENCHMARK.json`, so a new one is a new file and no edit."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


def checked_name(name: str) -> str:
    """``name`` if it is a benchmark name (letters, digits, ``_``, ``.``
    and ``-``, at most 64, not starting with ``.`` or ``-``), so that it
    can name a file and never leads out of its folder."""
    if not isinstance(name, str) or not NAME.match(name) or ".." in name:
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def load_json(folder: Path, name: str) -> dict:
    """``folder/<name>.json``."""
    path = folder / f"{checked_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    return json.loads(path.read_text())


def load_module(folder: Path, name: str) -> ModuleType:
    """``folder/<name>.py`` as a module of its own (a name may hold ``-``
    or ``.``, which an import statement cannot)."""
    path = folder / f"{checked_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_plugin.{folder.name}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
