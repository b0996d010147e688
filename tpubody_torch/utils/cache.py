"""Content-addressed stage cache (the port's copy of
``tpubody.utils.cache``; arrays in, arrays out: tensors are converted by
the caller).

The reference persists every stage's output as side-car files with
commented-out reload lines for manual resume (main.py:84-122,
lib/Warp.py:602-603, lib/Normal2Depth.py:232-234 — SURVEY.md §5
"checkpoint/resume").  This formalizes that scheme: each stage writes its
artifacts under the run directory with the SAME filenames the reference
uses, plus a manifest recording a hash of the stage inputs — a stage is
skipped iff its manifest entry matches the current input hash.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, Optional

import numpy as np


def digest(*arrays, **scalars) -> str:
    """Stable hash of arrays + scalar kwargs."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"none")
            continue
        a = np.asarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes()[:1 << 22])
    for k in sorted(scalars):
        h.update(f"{k}={scalars[k]}".encode())
    return h.hexdigest()[:32]


class StageCache:
    """Per-run-directory stage cache with a JSON manifest."""

    def __init__(self, run_dir: str, enabled: bool = True):
        self.run_dir = run_dir
        self.enabled = enabled
        os.makedirs(run_dir, exist_ok=True)
        self.manifest_path = os.path.join(run_dir, "stage_manifest.json")
        self._manifest: Dict[str, str] = {}
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    self._manifest = json.load(f)
            except (json.JSONDecodeError, OSError):
                self._manifest = {}

    def path(self, filename: str) -> str:
        return os.path.join(self.run_dir, filename)

    def _save_manifest(self) -> None:
        with open(self.manifest_path, "w") as f:
            json.dump(self._manifest, f, indent=1)

    def get(self, stage: str, input_hash: str, filenames) -> Optional[dict]:
        """Load a stage's artifacts if cached with a matching input hash."""
        if not self.enabled:
            return None
        if self._manifest.get(stage) != input_hash:
            return None
        out = {}
        for name in filenames:
            p = self.path(name)
            if not os.path.exists(p):
                return None
            out[name] = np.load(p, allow_pickle=False)
        return out

    def put(self, stage: str, input_hash: str, artifacts: Dict[str, np.ndarray]
            ) -> None:
        """Persist stage artifacts (reference side-car filenames) + hash."""
        for name, arr in artifacts.items():
            np.save(self.path(name).removesuffix(".npy"), np.asarray(arr))
        self._manifest[stage] = input_hash
        self._save_manifest()

    def run(self, stage: str, input_hash: str, filenames,
            compute: Callable[[], Dict[str, np.ndarray]]) -> dict:
        """get-or-compute helper."""
        cached = self.get(stage, input_hash, filenames)
        if cached is not None:
            return cached
        out = compute()
        self.put(stage, input_hash, out)
        return {k: np.asarray(v) for k, v in out.items()}
