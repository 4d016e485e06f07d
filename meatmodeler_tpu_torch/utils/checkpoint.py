"""Stage checkpointing: persist per-stage artifacts so later stages can
re-run independently (the port's copy of
``meatmodeler_tpu/utils/checkpoint.py``).

The reference keeps all intermediate state in Python locals and writes a
single terminal PLY (SURVEY.md §5.4: "no checkpoint/resume of any kind").
Here each pipeline stage can dump its outputs as compressed npz; a re-run
with the same ``checkpoint_dir`` resumes after the last completed stage —
e.g. re-tune the bundle adjuster or volume estimator without re-decoding and
re-matching the whole video.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["StageCheckpointer"]


class StageCheckpointer:
    """npz-per-stage checkpoint store. ``None`` directory disables it."""

    def __init__(self, directory: Optional[str]):
        self.dir = Path(directory) if directory else None
        if self.dir:
            self.dir.mkdir(parents=True, exist_ok=True)

    @property
    def enabled(self) -> bool:
        """Callers must gate ``save(...)`` on this: argument materialization
        (``np.asarray`` of device arrays) costs a full device->host readback
        even though ``save`` itself would no-op."""
        return self.dir is not None

    def path(self, stage: str) -> Optional[Path]:
        return self.dir / f"{stage}.npz" if self.dir else None

    def has(self, stage: str) -> bool:
        p = self.path(stage)
        return bool(p and p.exists())

    def save(self, stage: str, **arrays) -> None:
        if not self.dir:
            return
        np.savez_compressed(self.path(stage), **{
            k: np.asarray(v) for k, v in arrays.items()
        })

    def load(self, stage: str) -> Dict[str, np.ndarray]:
        with np.load(self.path(stage)) as data:
            return {k: data[k] for k in data.files}
