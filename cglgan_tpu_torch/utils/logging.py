"""Run directories and per-tick metrics.

Port of ``cglgan_tpu/utils/logging.py``: a run dir holds ``config.json``
(the frozen ``FedGANConfig``), ``metrics.jsonl`` with a ``metrics.csv`` and
``metrics.xlsx`` mirror rewritten every tick, and, with ``tensorboard=True``
(``--tensorboard``), TensorBoard scalars under ``<run>/tb/`` where
``torch.utils.tensorboard`` imports.

Reopening a run dir that has ticks (``--resume`` with the same ``--name``)
carries them into the CSV and XLSX mirrors, as the reference does.  Unlike
the reference, the carried ticks also carry the clock: the reference's
``train`` restarts ``wall_s`` at 0 on resume
(``cglgan_tpu/algos/runner.py:125``), so its resumed run dir logs a time
and a rate of the resumed part only.  Here a logged tick's ``wall_s``
continues from the last carried tick's, and ``rounds_per_s`` counts the
carried rounds and seconds too; ``train``'s own history keeps the
reference's meaning.

A run resumed from an earlier checkpoint than its last tick (a run cut by
a time limit at round 13 000, resumed from ``ckpt_10000``) logs the rounds
after the checkpoint again.  The reference keeps both copies of those
ticks; here ``resume_round`` (the restored state's round) drops the
carried ticks past it, from ``metrics.jsonl`` too, so that each round is
logged once and the clock continues from the checkpoint's tick.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from typing import Dict, Optional

from cglgan_tpu_torch.utils.xlsx import write_xlsx


class RunDir:
    """A run directory: ``<root>/<name>/`` with config.json, metrics.jsonl,
    metrics.csv, metrics.xlsx and image artifacts."""

    def __init__(self, root: str = "./logger", name: Optional[str] = None,
                 cfg=None, tensorboard: bool = False,
                 resume_round: Optional[int] = None):
        if name is None:
            stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
            algo = getattr(cfg, "algo", "run") if cfg is not None else "run"
            ds = getattr(cfg, "dataset", "") if cfg is not None else ""
            iid = getattr(cfg, "iid", "") if cfg is not None else ""
            name = f"{stamp}-{algo}-{ds}-iid{iid}"
        self.path = os.path.join(root, name)
        os.makedirs(self.path, exist_ok=True)
        jsonl_path = os.path.join(self.path, "metrics.jsonl")
        self._csv_path = os.path.join(self.path, "metrics.csv")
        self._csv_fields = None
        self._records = []
        # (seconds, rounds) the carried ticks had taken
        self._carried = (0.0, 0)
        if os.path.isfile(jsonl_path) and os.path.getsize(jsonl_path) > 0:
            with open(jsonl_path) as f:
                for line in f:
                    if line.strip():
                        self._records.append(json.loads(line))
            if resume_round is not None:
                kept = [r for r in self._records
                        if r.get("round", 0) <= resume_round]
                if len(kept) < len(self._records):
                    self._records = kept
                    with open(jsonl_path, "w") as f:
                        f.writelines(json.dumps(r) + "\n" for r in kept)
            if self._records:
                self._csv_fields = list(self._records[0].keys())
                with open(self._csv_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=self._csv_fields,
                                       extrasaction="ignore")
                    w.writeheader()
                    w.writerows(self._records)
                last = self._records[-1]
                if "wall_s" in last and "rounds_per_s" in last:
                    wall = float(last["wall_s"])
                    self._carried = (wall,
                                     round(wall * last["rounds_per_s"]))
            elif os.path.isfile(self._csv_path):
                os.remove(self._csv_path)    # every carried tick dropped
        self._jsonl = open(jsonl_path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(self.file("tb"))
            except ImportError:
                import warnings
                warnings.warn("tensorboard requested but not importable; "
                              "continuing with JSONL/CSV only")
        if cfg is not None:
            with open(os.path.join(self.path, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2)

    def file(self, name: str) -> str:
        return os.path.join(self.path, name)

    def _continue_clock(self, record: Dict) -> Dict:
        """``record`` with ``wall_s`` and ``rounds_per_s`` counted from the
        start of the run dir's first tick, not from the resume."""
        wall0, rounds0 = self._carried
        if not rounds0 or "wall_s" not in record \
                or "rounds_per_s" not in record:
            return record
        out = dict(record)
        done = round(record["wall_s"] * record["rounds_per_s"])
        out["wall_s"] = wall0 + record["wall_s"]
        out["rounds_per_s"] = (rounds0 + done) / out["wall_s"]
        return out

    def log(self, record: Dict) -> None:
        record = self._continue_clock(record)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        self._records.append(dict(record))
        new_file = self._csv_fields is None
        if new_file:
            self._csv_fields = list(record.keys())
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields,
                               extrasaction="ignore")
            if new_file:
                w.writeheader()
            w.writerow(record)
        # the reference's Excel export a tick (FLGAN/2DMG/flgan.py:102-103)
        write_xlsx(os.path.join(self.path, "metrics.xlsx"), self._records)
        if self._tb is not None:
            step = int(record.get("round", len(self._records)))
            for k, v in record.items():
                if k != "round" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
