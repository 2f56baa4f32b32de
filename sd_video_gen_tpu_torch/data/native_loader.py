"""Native (C++) batch loader: a ctypes binding over the port's own
``native/fastloader.cpp`` (``sd_video_gen_tpu/data/native_loader.py``; the
same cache files, epoch orders and batches, flips included).

The hot input path (epoch sampling, clip gather, augmentation, prefetch)
runs in C++ threads over a memory-mapped cache, outside the GIL (the
reference used 12 torch DataLoader worker *processes* re-decoding PNGs every
epoch). Python only sees ready uint8/f32 batch buffers.

Cache format: one raw binary file of N contiguous clip records + a small
JSON header (shape/dtype, and per-clip class labels where the dataset has
classes). ``build_frame_cache`` writes it from any indexable dataset.

The library is built by ``g++`` at first use into ``build/native/`` at the
repository root (git-ignored), under a name that hashes the source, the
flags and ``g++ --version``: an edited source or another compiler builds
anew, an unchanged one is loaded as it is. Nothing is built at import time.
No ``-march=native``: a library built on one host must run on another CPU
(the gather is memcpy-bound and gains nothing from it).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import json
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

# Host seconds spent blocked in fl_next_batch and the batches it handed over,
# summed over every loader of this process: what a training run waits for
# its input. chip_smoke.py's data phase clears it before a native-cache
# training run and reports it after (``run_native_path``).
NEXT_BATCH = collections.Counter()

_lib = None
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the library of this source, these flags and this compiler
    lives (built or not)."""
    version = subprocess.run([CXX, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256()
    for part in (SOURCE.read_bytes(), "\0".join(CXX_FLAGS).encode(),
                 version.encode()):
        h.update(len(part).to_bytes(8, "little") + part)
    return BUILD_DIR / f"libfastloader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader unless a library of the same key exists. The
    compiler writes a name of this process's own, renamed into place, so
    several processes may build at once."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed (exit {res.returncode}) building "
                           f"{SOURCE}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def _load_lib():
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.fl_open.restype = ctypes.c_void_p
        lib.fl_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int64] * 6
        lib.fl_start_epoch.restype = ctypes.c_int64
        lib.fl_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64]
        lib.fl_next_batch.restype = ctypes.c_int64
        lib.fl_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.fl_close.argtypes = [ctypes.c_void_p]
        lib.fl_close.restype = None
        _lib = lib
        return lib


def _scalar_label(x):
    """Best-effort class id from a dataset's first tuple element; None when
    the dataset has no class notion (e.g. ball yields frame-id strings)."""
    while isinstance(x, (list, tuple)):
        x = x[0]
    if isinstance(x, (int, np.integer)):
        return int(x)
    return None


def build_frame_cache(dataset, out_dir: str, stage: str) -> str:
    """Serialize an indexable (label_or_index, clip ndarray) dataset to the
    native cache format: <stage>.bin (raw records) + <stage>.json (header,
    incl. per-clip labels so text-conditioned training keeps its class
    ids: a clip INDEX fed to the text embedder is silently wrong)."""
    os.makedirs(out_dir, exist_ok=True)
    first = np.ascontiguousarray(dataset[0][1])
    shape, dtype = first.shape, first.dtype
    bin_path = os.path.join(out_dir, f"{stage}.bin")
    labels = []
    with open(bin_path, "wb") as f:
        for i in range(len(dataset)):
            lab, clip = dataset[i]
            labels.append(_scalar_label(lab))
            clip = np.ascontiguousarray(clip, dtype=dtype)
            if clip.shape != shape:
                raise ValueError(f"ragged clip in cache build: clip {i} has "
                                 f"shape {clip.shape}, clip 0 {shape}")
            f.write(clip.tobytes())
    hdr = {"n_clips": len(dataset), "shape": list(shape),
           "dtype": str(dtype)}
    if all(lab is not None for lab in labels):
        hdr["labels"] = labels  # class datasets only (UCF): clip -> class id
    with open(os.path.join(out_dir, f"{stage}.json"), "w") as f:
        json.dump(hdr, f)
    return bin_path


class NativeBatchLoader:
    """Drop-in for data/pipeline.BatchLoader, backed by the C++ runtime:
    yields (clip indices, numpy batch)."""

    def __init__(self, cache_dir: str, stage: str, batch_size: int,
                 epoch_ratio: float = 1.0, shuffle: bool = True,
                 drop_last: bool = True, n_threads: int = 2,
                 prefetch: int = 3, flip: bool = False, seed: int = 0,
                 process_shard: tuple[int, int] | None = None,
                 shard_multiple: int | None = None):
        with open(os.path.join(cache_dir, f"{stage}.json")) as f:
            hdr = json.load(f)
        # multi-process: identical semantics to pipeline.BatchLoader. Every
        # process derives the SAME global epoch order from the shared seed,
        # cuts it into GLOBAL batches of ``batch_size``, and feeds only its
        # contiguous per-process slice of each one to the C++ runtime (the
        # mmap'd cache is local). Ragged tails trim to ``shard_multiple``
        # (the data axis's requirement).
        if process_shard is not None:
            pid, pcount = process_shard
            if batch_size % pcount:
                raise ValueError(
                    f"global batch_size {batch_size} must divide evenly "
                    f"across {pcount} processes")
            if not (0 <= pid < pcount):
                raise ValueError(f"process_shard index {pid} out of range")
        self.process_shard = process_shard
        self.shard_multiple = (shard_multiple if shard_multiple is not None
                               else (process_shard[1] if process_shard
                                     else None))
        self._mult = max(self.shard_multiple or 1,
                         process_shard[1] if process_shard else 1)
        if self._mult > 1 and batch_size % self._mult:
            raise ValueError(
                f"global batch_size {batch_size} must be a multiple of "
                f"shard_multiple {self._mult} (the mesh batch-axis "
                "requirement) — every batch must shard evenly")
        if process_shard is not None and self._mult % process_shard[1]:
            # a ragged tail trims to a multiple of _mult, then splits into
            # per-process slices of _mult // pcount: a non-divisible pair
            # would yield a trimmed GLOBAL tail that no longer shards (the
            # trainer always passes lcm(data axis, process count))
            raise ValueError(
                f"shard_multiple {self._mult} must be a multiple of the "
                f"process count {process_shard[1]} — pass "
                "lcm(mesh data axis, process count)")
        self.shape = tuple(hdr["shape"])
        self.dtype = np.dtype(hdr["dtype"])
        self.n_clips = hdr["n_clips"]
        # labels: clip -> class id for class datasets, else None. The loader
        # always YIELDS clip indices; text-mode training maps them through
        # this table (train/trainer._LabelMappedLoader)
        self.labels = hdr.get("labels")
        self.clip_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self.batch_size = batch_size
        self.epoch_ratio = epoch_ratio
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.n_threads = n_threads
        self.prefetch = prefetch
        self.flip = flip
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

        lib = _load_lib()
        frames, height, width, channels = (list(self.shape) + [0, 0, 0, 0])[:4]
        if self.dtype != np.uint8 or len(self.shape) != 4:
            frames = height = width = channels = 0  # flat records, no augment
        self._h = lib.fl_open(
            os.path.join(cache_dir, f"{stage}.bin").encode(),
            self.n_clips, self.clip_bytes, frames, height, width, channels)
        if not self._h:
            raise OSError(f"fastloader could not open cache in {cache_dir}")
        self._lib = lib

    def __len__(self):
        take = max(1, int(self.n_clips * self.epoch_ratio))
        nfull, rem = divmod(take, self.batch_size)
        if nfull and self.drop_last:
            return nfull
        if self._mult > 1 or self.process_shard is not None:
            # a ragged tail survives only if it trims to a non-zero
            # shardable size (__iter__ applies the same rule)
            ragged = rem if nfull else take
            return nfull + (1 if (ragged // self._mult) * self._mult else 0)
        return nfull + (1 if rem else 0)

    def _epoch_order(self):
        """Per-process (order array, local batch size) for this epoch.

        The GLOBAL order and its batch boundaries are identical on every
        process (shared seed); each process keeps its contiguous slice of
        every global batch. Concatenating size-``local`` runs and cutting
        at stride ``local`` in C++ reproduces the run boundaries exactly,
        so global batch k = the k-th C++ batch on every process."""
        take = max(1, int(self.n_clips * self.epoch_ratio))
        order = (self._rng.permutation(self.n_clips)
                 if self.shuffle else np.arange(self.n_clips))[:take]
        if self.process_shard is None and self._mult <= 1:
            if self.drop_last and take >= self.batch_size:
                order = order[: (take // self.batch_size) * self.batch_size]
            return order, self.batch_size
        pid, pcount = self.process_shard or (0, 1)
        local_bs = self.batch_size // pcount
        nfull, rem = divmod(len(order), self.batch_size)
        pieces = [order[i * self.batch_size:(i + 1) * self.batch_size]
                  [pid * local_bs:(pid + 1) * local_bs]
                  for i in range(nfull)]
        if rem and not (nfull and self.drop_last):
            tail = order[nfull * self.batch_size:]
            m = (len(tail) // self._mult) * self._mult
            local = m // pcount
            if local:
                pieces.append(tail[pid * local:(pid + 1) * local])
        if not pieces:
            return order[:0], local_bs
        return np.concatenate(pieces), local_bs

    def __iter__(self):
        order, local_bs = self._epoch_order()
        order = np.ascontiguousarray(order, np.int64)
        if len(order) == 0:
            return
        self._epoch += 1
        # Fold the process index into the augmentation seed: the C++ flip
        # RNG is keyed on (seed, batch_idx), and batch_idx is the GLOBAL
        # batch number on every process; an unsalted seed would give local
        # position j on every process the same flip coin in every global
        # batch. pid=0 leaves the single-process stream as it was.
        pid = self.process_shard[0] if self.process_shard else 0
        aug_seed = self._epoch ^ ((pid * 0x9E3779B97F4A7C15) & (2**64 - 1))
        n_batches = self._lib.fl_start_epoch(
            self._h, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(order), local_bs, self.n_threads, self.prefetch,
            1 if self.flip else 0, aug_seed)
        if n_batches < 0:
            raise ValueError("fastloader rejected the epoch order "
                             "(clip id out of range for the cache)")
        served = ctypes.c_int64(0)
        buf = np.empty((local_bs,) + self.shape, self.dtype)
        idx = np.empty((local_bs,), np.int64)
        for _ in range(n_batches):
            t0 = time.perf_counter()
            n = self._lib.fl_next_batch(
                self._h, buf.ctypes.data_as(ctypes.c_void_p),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.byref(served))
            NEXT_BATCH["seconds"] += time.perf_counter() - t0
            if n <= 0:
                break
            NEXT_BATCH["batches"] += 1
            yield idx[:n].tolist(), buf[:n].copy()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def main(argv=None):
    """Build a native frame cache from any dataset the trainer's
    ``build_dataset`` addresses: python -m
    sd_video_gen_tpu_torch.data.native_loader --dataset ball --folder <dir>
    --config <cfg> --out frame_cache/"""
    from sd_video_gen_tpu_torch.config import build_arg_parser, load_config
    from sd_video_gen_tpu_torch.train.trainer import build_dataset
    p = build_arg_parser()
    p.add_argument("--out", type=str, default="frame_cache")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.config_dir)
    for stage in ("train", "test"):
        ds = build_dataset(cfg, args, stage)
        path = build_frame_cache(ds, args.out, stage)
        print(f"{stage}: {len(ds)} clips -> {path}")


if __name__ == "__main__":
    main()
