"""Golden-series regression gate.

The port's copy of ``pysdc_tpu/utils/golden.py``: the same JSON files, the
same ``check`` and ``flush``, so that ``examples/golden/*.json`` gates both
packages.  A torch tensor (on any device) is read as its numpy values.

The numerical analog of the reference's ``DataChecker``
(``pySDC/helpers/testing.py:15-105``, which writes ``_data.json`` and
compares against a committed ``_dataRef.json``), redesigned as a single
store keyed by test name:

- every flagship configuration records its result series under a unique key
- the committed reference file pins those series; any drift beyond
  (rtol, atol) fails the gate
- re-baselining is explicit: run with ``PYSDC_TPU_WRITE_GOLDEN=1`` and
  commit the diff (so every numerical change shows in the history)

Values are stored as plain lists of floats/ints so the JSON diff is
readable line-by-line.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch


class GoldenStore:
    """One JSON file of named reference series with tolerance-checked gets."""

    WRITE_ENV = 'PYSDC_TPU_WRITE_GOLDEN'

    def __init__(self, path):
        self.path = Path(path)
        self._data = {}
        if self.path.exists():
            with open(self.path) as fh:
                self._data = json.load(fh)
        self._dirty = False

    @property
    def writing(self) -> bool:
        return bool(os.environ.get(self.WRITE_ENV))

    def check(self, key: str, values, rtol: float = 1e-10, atol: float = 1e-12):
        """Gate ``values`` against the committed series under ``key``.

        In write mode the series is (re)recorded instead.  Integer series
        (iteration counts) must match exactly regardless of tolerances."""
        got = values.detach().cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)
        if self.writing:
            self._data[key] = dict(
                values=[v.item() if hasattr(v, 'item') else v for v in np.ravel(got)],
                shape=list(got.shape),
                rtol=rtol,
                atol=atol,
            )
            self._dirty = True
            return

        if key not in self._data:
            raise AssertionError(
                f'no golden series {key!r} in {self.path}; record it with {self.WRITE_ENV}=1'
            )
        entry = self._data[key]
        want = np.asarray(entry['values']).reshape(entry['shape'])
        if got.shape != want.shape:
            raise AssertionError(f'{key}: shape {got.shape} != golden {want.shape}')
        if np.issubdtype(want.dtype, np.integer) and np.issubdtype(got.dtype, np.integer):
            if not np.array_equal(got, want):
                raise AssertionError(f'{key}: integer series changed:\n got {got}\nwant {want}')
            return
        # tolerances pinned at record time keep the gate's strictness in the
        # committed file, not in test code
        rtol = entry.get('rtol', rtol)
        atol = entry.get('atol', atol)
        if not np.allclose(got, want, rtol=rtol, atol=atol):
            err = np.max(np.abs(got - want) / (atol + rtol * np.abs(want)))
            raise AssertionError(
                f'{key}: series drifted (max normalized err {err:.3g}, rtol={rtol}, atol={atol})\n'
                f' got {np.ravel(got)[:8]}...\nwant {np.ravel(want)[:8]}...'
            )

    def flush(self):
        """Write mode only: persist recorded series (sorted keys, stable diff)."""
        if self._dirty:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, 'w') as fh:
                json.dump(dict(sorted(self._data.items())), fh, indent=1)
                fh.write('\n')
            self._dirty = False
