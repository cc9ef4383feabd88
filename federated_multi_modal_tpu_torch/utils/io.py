"""Filesystem helpers (equivalent to the Dassl utils the reference imports:
``mkdir_if_missing``, ``read_json``, ``write_json``, ``listdir_nohidden``)."""

import json
import os
import os.path as osp


def mkdir_if_missing(dirname: str) -> None:
    if dirname and not osp.exists(dirname):
        os.makedirs(dirname, exist_ok=True)


def read_json(fpath: str):
    with open(fpath, "r") as f:
        return json.load(f)


def write_json(obj, fpath: str) -> None:
    mkdir_if_missing(osp.dirname(fpath))
    with open(fpath, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))


def listdir_nohidden(path: str, sort: bool = False):
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items
