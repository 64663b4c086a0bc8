"""Out-of-core ETL: chunked shuffle + round-robin merge for huge rating files.

The reference handles Yahoo-scale raw text that does not shuffle in RAM with
a three-pass pipeline (reference: data/rawToProto_xlarge.py:1-98): split the
input into b chunks, shuffle each chunk in memory, then merge by reading 1/b
of every chunk per output round and user-grouping within the round. This is
the same algorithm with the passes generalized:

* input in ANY supported format (streamed via data/streamfmt.iter_ratings),
* random scatter instead of sequential split (chunk k is a uniform sample of
  the whole file, so each merge round is already an unbiased global sample),
* optional train/test/valid splitting during the scatter pass,
* output as protobuf block frames, raw, or userwise text — written
  incrementally, never holding more than ~n/b ratings in memory.

Peak host memory is max(one chunk, one merge round) ~= n/b ratings at 12
bytes each; b is chosen from --mem-limit.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from tpu_mf.data import proto
from tpu_mf.data.streamfmt import iter_ratings, scan_stats

REC = np.dtype([("u", "<i4"), ("v", "<i4"), ("r", "<f4")])  # 12 B / rating


class ProtoWriter:
    """Incremental reference-format block-frame writer (user-grouped within
    each appended slice, like the reference's per-round dict grouping)."""

    def __init__(self, path: str, users_per_block: int = 1000):
        self._f = open(path, "wb")
        self._upb = users_per_block

    def append(self, u: np.ndarray, v: np.ndarray, r: np.ndarray) -> None:
        order = np.argsort(u, kind="stable")
        u, v, r = u[order], v[order], r[order]
        if not len(u):
            return
        change = np.nonzero(np.diff(u))[0] + 1
        starts = np.concatenate([[0], change])
        for b0 in range(0, len(starts), self._upb):
            s = starts[b0]
            e = (
                starts[b0 + self._upb]
                if b0 + self._upb < len(starts)
                else len(u)
            )
            payload = proto.serialize_block(u[s:e], v[s:e], r[s:e])
            self._f.write(struct.pack("<I", len(payload)))
            self._f.write(payload)

    def close(self) -> None:
        self._f.close()


class RawWriter:
    """Incremental raw-text writer; total count is patched into the header."""

    def __init__(self, path: str, total: int):
        self._f = open(path, "w")
        self._f.write(f"{total}\n")

    def append(self, u, v, r) -> None:
        lines = [f"{int(a)},{int(b)},{float(c):.9g},0\n" for a, b, c in zip(u, v, r)]
        self._f.write("".join(lines))

    def close(self) -> None:
        self._f.close()


class UserwiseWriter:
    """Incremental userwise writer (users grouped within each slice; a user
    may repeat across slices, as in the reference's merge output)."""

    def __init__(self, path: str, total: int = 0):
        self._f = open(path, "w")

    def append(self, u, v, r) -> None:
        order = np.argsort(u, kind="stable")
        out = []
        last = None
        for i in order:
            uu = int(u[i])
            if uu != last:
                out.append(f"{uu}:\n")
                last = uu
            out.append(f"{int(v[i])},{float(r[i]):.9g}\n")
        self._f.write("".join(out))

    def close(self) -> None:
        self._f.close()


def _writer(path: str, method: str, total: int, users_per_block: int):
    if method == "protobuf":
        return ProtoWriter(path, users_per_block)
    if method == "raw":
        return RawWriter(path, total)
    if method == "userwise":
        return UserwiseWriter(path)
    raise ValueError(f"unknown method {method}")


class _ChunkSet:
    """b append-mode chunk files of packed REC records for one output part."""

    def __init__(self, workdir: str, name: str, b: int):
        self.paths = [os.path.join(workdir, f"{name}.{i:04d}.chunk") for i in range(b)]
        self.files = [open(p, "ab") for p in self.paths]
        self.total = 0

    def scatter(self, dest: np.ndarray, u, v, r) -> None:
        rec = np.empty(len(u), REC)
        rec["u"], rec["v"], rec["r"] = u, v, r
        self.total += len(u)
        for i, f in enumerate(self.files):
            part = rec[dest == i]
            if len(part):
                part.tofile(f)

    def close_inputs(self) -> None:
        for f in self.files:
            f.close()


# observability hook for tests: records the largest in-memory slice (ratings)
_peak_in_memory = {"ratings": 0}


def _track(n: int) -> None:
    _peak_in_memory["ratings"] = max(_peak_in_memory["ratings"], int(n))


def _shuffle_and_merge(
    chunks: _ChunkSet, writer, rng: np.random.Generator
) -> int:
    """Pass 2+3: shuffle each chunk in place, then merge 1/b of every chunk
    per round (reference: rawToProto_xlarge.py merge loop)."""
    b = len(chunks.paths)
    lens: List[int] = []
    for p in chunks.paths:
        rec = np.fromfile(p, REC)
        _track(len(rec))
        rng.shuffle(rec)
        rec.tofile(p)
        lens.append(len(rec))

    offsets = [0] * b
    written = 0
    for rnd in range(b):
        parts = []
        for i, p in enumerate(chunks.paths):
            take = lens[i] // b + (lens[i] % b if rnd == b - 1 else 0)
            if take <= 0:
                continue
            with open(p, "rb") as f:
                f.seek(offsets[i] * REC.itemsize)
                parts.append(np.fromfile(f, REC, take))
            offsets[i] += take
        if not parts:
            continue
        merged = np.concatenate(parts)
        _track(len(merged))
        rng.shuffle(merged)  # mix the b sources within the round
        writer.append(merged["u"], merged["v"], merged["r"])
        written += len(merged)
    for p in chunks.paths:
        os.remove(p)
    return written


def xlarge_convert(
    read_path: str,
    write_path: str,
    method: str = "protobuf",
    users_per_block: int = 1000,
    mem_limit: int = 50_000_000,
    split: float = 0.0,
    valid: float = 0.0,
    seed: int = 0,
    workdir: Optional[str] = None,
) -> Tuple[int, ...]:
    """Convert/shuffle/split a rating file larger than host RAM.

    mem_limit is the maximum number of ratings ever held in memory at once
    (12 bytes each); b = ceil(n / mem_limit) chunk files are used. Returns
    the written counts per output part.
    """
    _peak_in_memory["ratings"] = 0
    _, _, n = scan_stats(read_path)
    b = max(1, -(-n // mem_limit))
    rng = np.random.default_rng(seed)

    own_workdir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="mf_xlarge_")
    os.makedirs(workdir, exist_ok=True)

    parts: List[Tuple[str, str]] = []  # (name, output path)
    if split > 0.0:
        if valid > 0.0:
            parts.append(("valid", f"{write_path}.valid"))
        parts.append(("train", f"{write_path}.train"))
        parts.append(("test", f"{write_path}.test"))
    else:
        parts.append(("train", write_path))

    sets = {name: _ChunkSet(workdir, name, b) for name, _ in parts}
    try:
        # Pass 1: stream the input, routing each rating to a random chunk of
        # its output part (test/valid membership drawn per rating).
        for u, v, r in iter_ratings(read_path, chunk=min(1 << 18, mem_limit)):
            _track(len(u))
            dest = rng.integers(0, b, len(u), dtype=np.int32)
            if split > 0.0:
                x = rng.random(len(u))
                is_test = x < split
                rest = ~is_test
                if valid > 0.0:
                    is_valid = rest & (x < split + (1 - split) * valid)
                    rest = rest & ~is_valid
                    sets["valid"].scatter(dest[is_valid], u[is_valid], v[is_valid], r[is_valid])
                sets["test"].scatter(dest[is_test], u[is_test], v[is_test], r[is_test])
                sets["train"].scatter(dest[rest], u[rest], v[rest], r[rest])
            else:
                sets["train"].scatter(dest, u, v, r)
        for s in sets.values():
            s.close_inputs()

        # Pass 2+3 per part: chunk shuffle, round-robin merge, stream-write.
        counts = []
        for name, path in parts:
            writer = _writer(path, method, sets[name].total, users_per_block)
            try:
                counts.append(_shuffle_and_merge(sets[name], writer, rng))
            finally:
                writer.close()
        return tuple(counts)
    finally:
        if own_workdir:
            try:
                for f in os.listdir(workdir):
                    os.remove(os.path.join(workdir, f))
                os.rmdir(workdir)
            except OSError:
                pass
