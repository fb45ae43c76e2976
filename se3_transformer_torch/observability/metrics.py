"""The schema'd JSONL metric stream: the port of
se3_transformer_tpu/observability/metrics.py's host half.

`MetricLogger` writes one JSON record per line, each with `kind` and
`run_id`, behind a `run_meta` header that names the host, the code and
the card (its name and power limit: a time means little without them).
`merge_windows` folds flushed {count, mean, min, max} windows into a
run's cumulative view. The on-device `MetricAccumulator` of the training
step comes with ROADMAP A2.5.
"""
from __future__ import annotations

import json
import os
import subprocess
import threading
import time
import uuid
from typing import Optional

import torch

from .schema import SCHEMA_VERSION


def merge_windows(cum: Optional[dict], window: dict) -> dict:
    """Host-side running merge of flushed windows (for the run summary)."""
    if cum is None:
        return {k: dict(v) for k, v in window.items()}
    out = dict(cum)
    for name, w in window.items():
        if not w['count']:
            continue
        c = out.get(name)
        if not c or not c['count']:
            out[name] = dict(w)
            continue
        n = c['count'] + w['count']
        out[name] = dict(
            count=n,
            mean=(c['mean'] * c['count'] + w['mean'] * w['count']) / n,
            min=min(c['min'], w['min']),
            max=max(c['max'], w['max']))
    return out


def _code_rev() -> Optional[str]:
    """The package tree's git object id (SE3_TORCH_CODE_REV wins when
    set); None outside a git checkout."""
    rev = os.environ.get('SE3_TORCH_CODE_REV')
    if rev:
        return rev
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ['git', 'rev-parse', 'HEAD:se3_transformer_torch'], cwd=root,
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def _power_limit() -> Optional[str]:
    """Card 0's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader', '--id=0'],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def collect_run_meta(extra: Optional[dict] = None) -> dict:
    """Host, code and device metadata stamped at the head of every stream:
    the backend ('cuda' when a card is present, else 'cpu'; `extra` may
    name the one the run uses), and on a card its name
    (torch.cuda.get_device_name), count and power limit (nvidia-smi)."""
    import platform
    import sys
    cuda = torch.cuda.is_available()
    meta = dict(
        kind='run_meta',
        schema_version=SCHEMA_VERSION,
        time_utc=time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime()),
        code_rev=_code_rev(),
        backend='cuda' if cuda else 'cpu',
        device_kind=torch.cuda.get_device_name(0) if cuda else None,
        device_count=torch.cuda.device_count() if cuda else 0,
        power_limit=_power_limit() if cuda else None,
        host=dict(hostname=platform.node(), pid=os.getpid(),
                  python=sys.version.split()[0], torch=torch.__version__),
    )
    if extra:
        meta.update(extra)
    return meta


def _round_floats(obj, ndigits=4):
    if isinstance(obj, float):
        return round(obj, ndigits)
    if isinstance(obj, dict):
        return {k: _round_floats(v, ndigits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v, ndigits) for v in obj]
    return obj


class MetricLogger:
    """Structured JSONL metric stream + stdout mirror.

    Every record carries `kind` and `run_id`; the first record of a
    stream is a `run_meta` header, written lazily at the first log. As a
    context manager it closes the file on any exit path.
    """

    def __init__(self, path: Optional[str] = None, mirror=print,
                 run_meta: Optional[dict] = None):
        self.path = path
        self.mirror = mirror
        self.run_id = uuid.uuid4().hex[:12]
        self._extra_meta = dict(run_meta) if run_meta else {}
        self._meta_written = False
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        self._fh = open(path, 'a') if path else None
        self._t0 = time.time()
        # reentrant: _ensure_meta writes the header while already inside
        # the locked region; loggers shared by threads keep run_meta first
        self._lock = threading.RLock()

    # -- plumbing -------------------------------------------------------- #
    def _write(self, rec: dict):
        with self._lock:
            if self._fh:
                self._fh.write(json.dumps(rec) + '\n')
                self._fh.flush()

    def _ensure_meta(self):
        with self._lock:
            if self._meta_written:
                return
            meta = collect_run_meta(self._extra_meta)
            meta['run_id'] = self.run_id
            self._write(meta)
            self._meta_written = True
        if self.mirror:
            self.mirror(f'run {self.run_id} backend={meta.get("backend")} '
                        f'device={meta.get("device_kind")} '
                        f'code_rev={meta.get("code_rev")}')

    @staticmethod
    def _fmt(v):
        # fixed precision in the stdout mirror (the JSONL keeps it all)
        if isinstance(v, float):
            return f'{v:.4g}'
        if isinstance(v, dict):
            return json.dumps(_round_floats(v), separators=(',', ':'))
        return str(v)

    # -- logging API ----------------------------------------------------- #
    def log(self, step: int, **metrics) -> dict:
        """One per-step record (kind='step'). Returns the record."""
        self._ensure_meta()
        rec = dict(kind='step', run_id=self.run_id, step=step,
                   t=round(time.time() - self._t0, 3))
        rec.update({k: (float(v) if hasattr(v, 'item') else v)
                    for k, v in metrics.items()})
        self._write(rec)
        if self.mirror:
            shown = {k: v for k, v in rec.items()
                     if k not in ('kind', 'run_id')}
            self.mirror(' '.join(f'{k}={self._fmt(v)}'
                                 for k, v in shown.items()))
        return rec

    def log_record(self, kind: str, mirror: bool = True, **fields) -> dict:
        """One structured record of an arbitrary kind (serve / cost /
        summary / ...). Returns the record."""
        self._ensure_meta()
        rec = dict(kind=kind, run_id=self.run_id,
                   t=round(time.time() - self._t0, 3))
        rec.update(fields)
        self._write(rec)
        if self.mirror and mirror:
            shown = {k: v for k, v in rec.items() if k != 'run_id'}
            self.mirror(' '.join(f'{k}={self._fmt(v)}'
                                 for k, v in shown.items()))
        return rec

    # -- lifecycle ------------------------------------------------------- #
    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
