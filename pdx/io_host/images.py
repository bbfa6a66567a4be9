"""Host-side image ingestion (TIFF stacks of real laser-matter frames).

Parity: the four near-copy loaders in the reference —
transport_pde_discovery.py:26-44, patch_based_pde_discovery.py:101-122,
analyze_results.py:201-218, patch_based_sindy.py:62-86. All glob sorted
``*.tif`` (<= max_images), read grayscale (converting BGRA/BGR when needed),
and cast to float. Decode prefers cv2, falls back to PIL, then to raw numpy
(.npy stacks) so the framework runs in cv2-free environments.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np

from pdx.utils.hostmem import huge_empty

try:  # host-side decode backends, best-effort
    import cv2  # type: ignore
except Exception:  # pragma: no cover
    cv2 = None

try:
    from PIL import Image  # type: ignore
except Exception:  # pragma: no cover
    Image = None


def _fast_tiff_gray(path: Path) -> np.ndarray | None:
    """Minimal raw decoder for the TIFF layout lab cameras (and cv2/PIL
    writers) actually emit: uncompressed, single-plane grayscale, 8- or
    16-bit unsigned, strip-organized. Returns None for anything fancier so
    the caller falls back to cv2/PIL.

    Why: cv2.imread costs ~0.4 s/frame in bulk on this host (the decode +
    per-call allocation path is CPU-bound on the single core) where reading
    the strip bytes and viewing them as a (H, W) array is ~milliseconds —
    a 51-frame cold load drops from ~21 s to ~2 s.
    """
    import struct

    try:
        b = path.read_bytes()
        if b[:2] == b"II":
            bo = "<"
        elif b[:2] == b"MM":
            bo = ">"
        else:
            return None
        magic, ifd = struct.unpack_from(bo + "HI", b, 2)
        if magic != 42:
            return None
        (n_tags,) = struct.unpack_from(bo + "H", b, ifd)
        tags: dict[int, tuple[int, int, int]] = {}
        for i in range(n_tags):
            tag, typ, cnt = struct.unpack_from(bo + "HHI", b, ifd + 2 + i * 12)
            tags[tag] = (typ, cnt, ifd + 2 + i * 12 + 8)

        def read_vals(tag: int, default=None) -> list[int] | None:
            if tag not in tags:
                return default
            typ, cnt, field = tags[tag]
            fmt, size = {3: ("H", 2), 4: ("I", 4)}.get(typ, (None, None))
            if fmt is None:
                return None
            # values are left-justified in the 4-byte field; larger arrays
            # live at the offset the field holds
            pos = field if cnt * size <= 4 else struct.unpack_from(bo + "I", b, field)[0]
            return list(struct.unpack_from(bo + fmt * cnt, b, pos))

        def one(tag: int, default=None) -> int | None:
            v = read_vals(tag, None if default is None else [default])
            return None if not v else v[0]

        w, h = one(256), one(257)
        bits = one(258, 8)
        if (
            w is None or h is None
            or one(259, 1) != 1          # uncompressed only
            or one(262, 1) != 1          # BlackIsZero grayscale only
            or one(277, 1) != 1          # single sample/px
            or one(284, 1) != 1          # chunky planar
            or one(339, 1) != 1          # unsigned int samples
            or bits not in (8, 16)
        ):
            return None
        offsets = read_vals(273)
        counts = read_vals(279)
        if not offsets or not counts or len(offsets) != len(counts):
            return None
        nbytes = h * w * (bits // 8)
        if sum(counts) != nbytes:
            return None
        if len(offsets) == 1:
            raw = b[offsets[0] : offsets[0] + nbytes]
        else:
            raw = b"".join(b[o : o + c] for o, c in zip(offsets, counts))
        dt = np.dtype("u2" if bits == 16 else "u1").newbyteorder(bo)
        arr = np.frombuffer(raw, dtype=dt).reshape(h, w)
        return arr
    except Exception:
        return None


def _read_gray(path: Path) -> np.ndarray | None:
    img = _fast_tiff_gray(path)
    if img is not None:
        return img
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            return None
        if img.ndim == 3:
            if img.shape[2] == 4:
                img = cv2.cvtColor(img, cv2.COLOR_BGRA2GRAY)
            else:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return img
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("L"))
    raise RuntimeError("no image decode backend available (cv2/PIL)")


# in-process decoded-stack cache: the warm pass of every pipeline (and any
# notebook/server process that re-runs the suite on the same immutable
# stack) re-pays a multi-second host I/O read of the disk cache entry on
# this class of host (~12 MB/s effective: 23 s for the 267 MB f32
# reference-scale stack, measured 2026-08-18). Entries are published
# READ-ONLY — a caller mutating the returned array would corrupt every
# later hit, so numpy is told to fail loudly instead. Keyed identically to
# the disk cache (content key), capped to a handful of stacks (128 GB host).
_MEM_CACHE: dict[str, np.ndarray] = {}
_MEM_CACHE_CAP = 4


def clear_stack_memcache() -> None:
    """Drop the in-process decoded-stack cache (benchmark harnesses call
    this before a 'cold' pass so cold timings include the real load)."""
    _MEM_CACHE.clear()
    _DEVICE_STACK.clear()


# Device-residency companion to the memcache: re-shipping the full-res
# stack (u16 = 134 MB host-to-device at reference scale) on every run is
# overhead: a long-lived session re-running a pipeline on the same decoded
# stack should pay the ship once — the regime the warm numbers describe.
# Two slots:
# the raw-dtype ship (analyze/patch heads cast inside their fused jit
# programs) and one casted variant (transport). Entries assume read-only
# stacks (the memcache publishes read-only; callers passing U_raw in must
# not mutate it afterwards).
_DEVICE_STACK: dict[tuple, object] = {}
_DEVICE_STACK_CAP = 2


def device_stack(U_raw: np.ndarray, dtype=None):
    """Ship ``U_raw`` to the default device (optionally casting), caching
    the device buffer so an identical re-ship is free. Opt out with
    ``PDX_DEVICE_STACK_CACHE=0``."""
    import jax.numpy as jnp

    if os.environ.get("PDX_DEVICE_STACK_CACHE", "1") == "0":
        arr = jnp.asarray(U_raw)
        return arr.astype(dtype) if dtype is not None else arr
    # id() alone can be reused after gc — add shape/dtype and a strided
    # content fingerprint (a few thousand elements, ~free vs the 134 MB ship)
    samp = np.ascontiguousarray(U_raw[::5, ::61, ::67])
    key = (
        id(U_raw), U_raw.shape, str(U_raw.dtype),
        None if dtype is None else str(jnp.dtype(dtype)),
        hash(samp.tobytes()),
    )
    hit = _DEVICE_STACK.get(key)
    if hit is not None:
        return hit
    arr = jnp.asarray(U_raw)
    if dtype is not None:
        arr = arr.astype(dtype)
    while len(_DEVICE_STACK) >= _DEVICE_STACK_CAP:
        _DEVICE_STACK.pop(next(iter(_DEVICE_STACK)))
    _DEVICE_STACK[key] = arr
    return arr


def _cache_dir() -> Path:
    return Path(
        os.environ.get("PDX_STACK_CACHE_DIR")
        or Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache")) / "pdx" / "stacks"
    )


def _cache_key(files: list[Path], mode: str, dtype) -> str:
    """Content key over the exact decode inputs: per-file (name, size,
    mtime_ns) plus decode mode/dtype. Any touched/replaced frame changes
    the key, so a stale cache can never be returned."""
    h = hashlib.sha1()
    h.update(f"{mode}|{np.dtype(dtype).str}".encode())
    for f in files:
        st = f.stat()
        h.update(f"|{f}|{st.st_size}|{st.st_mtime_ns}".encode())
    return h.hexdigest()


def _cache_load(key: str) -> np.ndarray | None:
    path = _cache_dir() / f"{key}.npy"
    if not path.exists():
        return None
    try:
        # memory-mapped: the warm cross-process load defers the one
        # streaming pass to the consumer's first touch (usually the device
        # transfer) instead of paying an eager 267 MB copy through this
        # host's ~20-40 MB/s memory up front
        return np.load(path, mmap_mode="r")
    except Exception:  # truncated/corrupt cache entry: fall through to decode
        return None


def _cache_store(key: str, stack: np.ndarray) -> None:
    d = _cache_dir()
    try:
        d.mkdir(parents=True, exist_ok=True)
        # atomic publish: a crash mid-write must never leave a readable
        # half-entry under the final name
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npy.tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.save(fh, stack)
            os.replace(tmp, d / f"{key}.npy")
        except BaseException:
            os.unlink(tmp)
            raise
    except Exception:  # cache is best-effort; decode result is already in hand
        pass


def load_images(
    folder: str | Path,
    *,
    max_images: int = 51,
    pattern: str = "*.tif",
    mode: str = "unchanged",  # unchanged | grayscale_u8
    dtype=np.float32,
    cache: bool | None = None,
) -> np.ndarray:
    """Load a sorted image stack as (T, H, W) float array.

    ``mode='grayscale_u8'`` matches analyze_results.py:204
    (IMREAD_GRAYSCALE); ``'unchanged'`` matches the other loaders
    (IMREAD_UNCHANGED + gray conversion).

    ``cache``: two-level decoded-stack cache (default on; disable with
    ``PDX_STACK_CACHE=0``, memory level alone with ``PDX_STACK_MEMCACHE=0``).
    Every pipeline in the suite re-reads the same immutable 51-frame stack.
    Disk entries live under ``~/.cache/pdx/stacks`` keyed by (file list,
    sizes, mtimes, mode, dtype) — touching any frame invalidates — stored in
    the REQUESTED dtype (an integer request is downgraded to float32 when
    the decoded frames can't be safely cast) and read back memory-mapped, so
    a warm cross-process
    load costs one streaming pass when downstream first touches the data
    instead of an eager copy. Within one process, hits come straight from
    ``_MEM_CACHE`` (read-only aliases, zero I/O). Frames are cast per-frame
    at decode time while each 2.6 MB frame is still cache-hot: this host's
    memory streams large arrays at ~20-40 MB/s, so a whole-stack
    ``astype(f32)`` costs ~15 s (measured 2026-08-18) where the fused
    per-frame cast is ~free. The reference re-decodes per script run (it has
    no loader layer to hang a cache on); benchmark harnesses call
    :func:`clear_stack_memcache` and point ``PDX_STACK_CACHE_DIR`` at a
    fresh dir so their cold timings still include the full decode (the
    entry WRITE happens on a background daemon thread — the caller never
    waits on the I/O-throttled disk; :func:`flush_stack_cache_writes`
    joins it).
    """
    folder = Path(folder)
    files = sorted(folder.glob(pattern))[: int(max_images)]
    if not files:
        # allow .npy stack fallback for synthetic testing environments
        npy = sorted(folder.glob("*.npy"))
        if npy:
            U = np.load(npy[0])
            req = np.dtype(dtype)
            if np.issubdtype(req, np.integer) and not np.can_cast(U.dtype, req, "safe"):
                req = np.dtype(np.float32)  # integer request is a hint only
            return U[: int(max_images)].astype(req)
        raise FileNotFoundError(f"No {pattern} files found in: {folder}")

    if cache is None:
        cache = os.environ.get("PDX_STACK_CACHE", "1") != "0"
    key = _cache_key(files, mode, dtype) if cache else None
    use_mem = key is not None and os.environ.get("PDX_STACK_MEMCACHE", "1") != "0"
    if use_mem and key in _MEM_CACHE:
        return _MEM_CACHE[key]
    if key is not None:
        hit = _cache_load(key)
        if hit is not None:
            # entry from an older layout: upcast only — a float entry under
            # an integer key means the source frames weren't integer and the
            # requested dtype was downgraded (see the allocation below)
            if hit.dtype != np.dtype(dtype) and np.can_cast(hit.dtype, np.dtype(dtype), "safe"):
                hit = hit.astype(dtype)
            if use_mem:
                return _mem_publish(key, hit)
            # memcache disabled == caller wants a writable result, but
            # _cache_load returns a read-only memmap: materialize a copy
            buf = huge_empty(hit.shape, hit.dtype)
            buf[...] = hit
            return buf

    def read_one(f: Path) -> np.ndarray | None:
        if mode == "grayscale_u8":
            img = _fast_tiff_gray(f)
            if img is not None:
                # cv2.imread(IMREAD_GRAYSCALE) maps 16-bit to 8-bit by
                # dropping the low byte (verified bit-equal on this data)
                return (img >> 8).astype(np.uint8) if img.dtype.itemsize == 2 else img
            if cv2 is not None:
                return cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
        return _read_gray(f)

    # sequential decode, cast-assign each frame straight into one
    # preallocated output block: per-frame casts run cache-hot (a
    # whole-stack astype pass costs ~15 s through this host's slow memory),
    # and a decode thread pool is 2.2x SLOWER than this loop on the single
    # core (measured 2026-08-18: GIL/allocator thrash)
    out: np.ndarray | None = None
    kept = 0
    for f in files:
        img = read_one(f)
        if img is None:
            continue
        if out is None:
            # An INTEGER dtype request is a transfer-size hint (ship raw
            # camera bytes to the device); honor it only when the decoded
            # frames really are integers that fit. Float or wider-integer
            # sources fall back to the old float32 default instead of
            # silently truncating/wrapping through the C cast below.
            store_dtype = np.dtype(dtype)
            if np.issubdtype(store_dtype, np.integer) and not np.can_cast(
                img.dtype, store_dtype, "safe"
            ):
                store_dtype = np.dtype(np.float32)
            # huge-page block: first-touch page faults on a fresh 267 MB
            # np.empty cost ~33 s on this host (pdx/utils/hostmem.py)
            out = huge_empty((len(files),) + img.shape, store_dtype)
        elif np.issubdtype(out.dtype, np.integer) and not np.can_cast(
            img.dtype, out.dtype, "safe"
        ):
            # heterogeneous stack: a later frame no longer fits the integer
            # block — widen everything stored so far (pathological, one copy)
            widened = huge_empty(out.shape, np.float32)
            widened[:kept] = out[:kept]
            out = widened
        out[kept] = img
        kept += 1
    if out is None or kept == 0:
        raise RuntimeError("no readable images found in the data directory")
    out = out[:kept]
    if use_mem:
        out = _mem_publish(key, out)
    if key is not None:
        # the entry write streams hundreds of MB through an I/O-throttled
        # disk (measured up to 50 s); never make the caller wait on it. The
        # array is immutable (read-only publish) when memcached — write
        # from a daemon thread; fall back to a synchronous store when the
        # caller asked for a writable result.
        if use_mem:
            _store_async(key, out)
        else:
            _cache_store(key, out)
    return out


def _mem_publish(key: str | None, stack: np.ndarray) -> np.ndarray:
    """Insert into the in-process cache (FIFO-capped) and return the entry
    read-only: every later hit aliases this exact array."""
    stack.setflags(write=False)
    if key is not None:
        while len(_MEM_CACHE) >= _MEM_CACHE_CAP:
            _MEM_CACHE.pop(next(iter(_MEM_CACHE)))
        _MEM_CACHE[key] = stack
    return stack


_PENDING_STORES: list = []


def _store_async(key: str, stack: np.ndarray) -> None:
    import threading

    t = threading.Thread(target=_cache_store, args=(key, stack), daemon=True)
    t.start()
    _PENDING_STORES.append(t)


def flush_stack_cache_writes(timeout: float | None = None) -> None:
    """Join pending background disk-cache writes (tests / harnesses that
    need the entry on disk before spawning the next process)."""
    while _PENDING_STORES:
        _PENDING_STORES.pop().join(timeout)


def list_image_resolutions(folder: str | Path, pattern: str = "*.tif") -> dict[tuple[int, int], int]:
    """Size histogram of an image folder (scripts/list_image_resolutions.py)."""
    folder = Path(folder)
    hist: dict[tuple[int, int], int] = {}
    for f in sorted(folder.glob(pattern)):
        img = _read_gray(f)
        if img is None:
            continue
        key = (int(img.shape[0]), int(img.shape[1]))
        hist[key] = hist.get(key, 0) + 1
    return hist
