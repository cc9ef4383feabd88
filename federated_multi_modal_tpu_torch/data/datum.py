"""Datum: one labeled (and optionally captioned) image record.

Equivalent of the *patched* Dassl ``Datum`` the reference requires — the
fork extends stock Dassl with a ``caption`` field (``datasets/ucmerced.py:21``,
consumed at ``trainers/maple.py:541``), so caption is first-class here.
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Datum:
    impath: str = ""
    label: int = 0
    domain: int = 0
    classname: str = ""
    caption: str = field(default="")

    def __post_init__(self):
        if not isinstance(self.label, int):
            object.__setattr__(self, "label", int(self.label))
