"""Stream labels.

the equivalent of ``Pothos::Label``: sparse (id, data, index, width)
annotations carried alongside a sample stream (reference usage: framing via
frameStart/frameEnd labels digital/FrameInsert.cpp:199-281, sample-accurate
reconfiguration math/Scale.cpp:104-122, trigger events
utility/WaveTrigger.cpp:647-656).

A label's ``index`` is relative to the start of the buffer it currently
rides with; the runtime re-bases indices as data is consumed/produced.
``toAdjusted(mul, div)`` mirrors Pothos's rational index rescale used by
rate-changing blocks (reference: digital/BytesToSymbols.cpp:158-165,
filter/FIRFilter.cpp:311-323).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Label:
    id: str
    data: Any = None
    index: int = 0
    width: int = 1

    def to_adjusted(self, mul: int, div: int) -> "Label":
        """Rescale index and width by mul/div (integer floor), as a
        rate-changing block does when propagating labels."""
        return Label(
            id=self.id,
            data=self.data,
            index=(self.index * mul) // div,
            width=max(1, (self.width * mul) // div),
        )

    def shifted(self, delta: int) -> "Label":
        return dataclasses.replace(self, index=self.index + delta)
