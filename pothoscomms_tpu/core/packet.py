"""Packets — framed buffers with labels and metadata.

the equivalent of ``Pothos::Packet``: a payload buffer plus a list of
labels (indexed relative to payload start) and a metadata dict (reference
usage: mac/SimpleMac.cpp:124-177 packet I/O, digital/BytesToSymbols.cpp:91-119
stream/packet dual mode, utility/WaveTrigger.cpp:515-591 scope events).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from pothoscomms_tpu.core.dtypes import DType
from pothoscomms_tpu.core.labels import Label


@dataclasses.dataclass
class Packet:
    payload: np.ndarray
    dtype: DType | None = None
    labels: List[Label] = dataclasses.field(default_factory=list)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.dtype is None and isinstance(self.payload, np.ndarray):
            if np.iscomplexobj(self.payload):
                self.dtype = DType.parse(self.payload.dtype)
            else:
                self.dtype = DType.parse(self.payload.dtype)

    @property
    def elements(self) -> int:
        return int(self.payload.shape[0]) if self.payload is not None else 0
