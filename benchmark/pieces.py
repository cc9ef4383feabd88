"""The benchmark's pieces, each a file found by its name under a checkout.

A piece of ``group`` named ``name`` is ``benchmark/<group>/<name>.py`` of
the checkout ``root``: a kind of loop (``kinds``), an architecture
(``architectures``) or a per-layer metric's reader (``metrics``). It is
loaded from that file, so that a piece added as a new file is found with
no other file edited.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

# modules of a group that its pieces share, and no piece
SHARED = {"__init__", "common"}


def names(root: Path, group: str) -> list:
    """The pieces of ``group`` in ``root``."""
    return sorted(p.name[:-3] for p in (Path(root) / "benchmark" / group).glob("*.py")
                  if p.name[:-3] not in SHARED)


def load(root: Path, group: str, name: str):
    """The module of piece ``name`` of ``group``; raises with the known
    names where there is none."""
    path = Path(root) / "benchmark" / group / f"{name}.py"
    if name in SHARED or not path.is_file():
        raise ValueError(f"no {group} piece {name!r} (benchmark/{group}/{name}.py); "
                         f"known: {names(root, group)}")
    module_name = f"benchmark_{group}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
