"""Image-streaming engine mode: particle sets larger than device memory.

The reference never holds the full working set on the GPU — images are
tiled through in chunks of ``nTotParallelMaps`` = 1024
(BioEM map.cpp:549, include/defs.h:182). The analogue here is
an outer **host loop over image chunks**: the engine is built once (CTF
bank, orientation blocks, compiled step), and each chunk swaps only the
image banks in (:meth:`BioEMEngine.swap_images` — same shapes, so the
jitted step is reused with zero retracing).

Streaming composes with the (images × orientations) device mesh and with
multi-host execution, exactly as in the reference where image chunking and
rank-sliced orientations compose per MPI rank (map.cpp:549 +
bioem.cpp:748-753): with ``cfg.mesh_images``/``cfg.mesh_orient`` > 1 the
chunk engine is a :class:`ShardedBioEMEngine`, each chunk's banks are
placed according to the mesh sharding, and under multi-host execution each
process reads only the image rows its devices own (per-host ingest; the
first chunk is read fully everywhere so the checkpoint fingerprint is
process-independent).

Chunking trades re-projection for memory: every chunk re-runs the full
orientation scan, so projection + CTF work is repeated ``n_chunks`` times.
That is the right trade — the posterior state is per-image (cross-chunk
merging is plain concatenation, unlike the orientation axis whose state
must be LSE-merged), and projection should be a small fraction of the
block step: one (O·Pp, N)×(N, F) matmul pair per radius group vs the
O(O·C·I) comparison (its measured share: tools/trace_step.py).

Memory per chunk: chunk_images × N × (N/2+1) × 2 float32 (conj-FFT bank)
plus the per-image state — ~11 MB per 1024 224² images, so a 50k-image set
streams through a single card without holding its 20 GB bank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Protocol

import numpy as np

from .config import RunConfig
from .core.engine import BioEMEngine, Results
from .io.map_io import ImageStack, _normalize_stack
from .io.mrc import read_mrc_header


class ImageSource(Protocol):
    """Chunked access to a (possibly huge) particle set."""

    @property
    def n_images(self) -> int: ...

    def chunk(self, start: int, stop: int) -> np.ndarray:
        """(stop-start, N, N) float32, already normalised."""
        ...


@dataclass
class ArraySource:
    """In-RAM stack (an ImageStack or ndarray) exposed as an ImageSource."""

    maps: np.ndarray

    @property
    def n_images(self) -> int:
        return self.maps.shape[0]

    def chunk(self, start: int, stop: int) -> np.ndarray:
        return self.maps[start:stop]


@dataclass
class MRCStackSource:
    """Lazy single-file MRC stack: only the requested chunk is read and
    normalised (reference map.cpp:663-853 semantics — transpose + per-image
    zero-mean/unit-σ unless NO_MAP_NORM)."""

    path: str
    n_pixels: int
    normalize: bool = True

    def __post_init__(self):
        hdr = read_mrc_header(self.path)
        if hdr.nr != self.n_pixels or hdr.nc != self.n_pixels:
            raise ValueError(
                f"Inconsistent number of pixels in maps and inputfile "
                f"({self.n_pixels}, i {hdr.nc}, j {hdr.nr})"
            )
        if hdr.mode != 2:
            raise ValueError(f"MRC mode {hdr.mode} not supported (mode-2 only)")
        self._hdr = hdr

    @property
    def n_images(self) -> int:
        return self._hdr.ns

    def chunk(self, start: int, stop: int) -> np.ndarray:
        hdr = self._hdr
        n = self.n_pixels
        per = n * n
        with open(self.path, "rb") as f:
            f.seek(1024 + hdr.nsymbt + start * per * 4)
            dt = np.dtype(hdr.byteorder + "f4")
            data = np.fromfile(f, dtype=dt, count=(stop - start) * per)
        if data.size != (stop - start) * per:
            raise IOError(f"Converting Data: {self.path}")
        data = data.astype(np.float32).reshape(stop - start, n, n)
        stack = np.ascontiguousarray(np.transpose(data, (0, 2, 1)))
        return _normalize_stack(stack) if self.normalize else stack


def _concat_results(parts: list[Results]) -> Results:
    first = parts[0]

    def cat(field):
        return np.concatenate([getattr(r, field) for r in parts])

    angle_log = None
    angle_raw = None
    if first.angle_log is not None:
        angle_log = np.concatenate([r.angle_log for r in parts], axis=0)
        angle_raw = tuple(
            np.concatenate([r.angle_raw[k] for r in parts], axis=0)
            for k in range(2)
        )
    return Results(
        log_prob=cat("log_prob"),
        constoadd=cat("constoadd"),
        total=cat("total"),
        best_orient=cat("best_orient"),
        best_conv=cat("best_conv"),
        best_cent_x=cat("best_cent_x"),
        best_cent_y=cat("best_cent_y"),
        best_norm=cat("best_norm"),
        best_mu=cat("best_mu"),
        angle_log=angle_log,
        log_norm_const=first.log_norm_const,
        angle_raw=angle_raw,
        grid=first.grid,
    )


def _read_chunk_local(source: ImageSource, start: int, stop: int, eng) -> np.ndarray:
    """Chunk [start, stop), reading from disk only the rows this process'
    devices own (multi-host per-host ingest). Unowned rows are filled with
    a finite placeholder — they are never placed on a local device
    (put_sharded materialises owned shards only), so their values are
    irrelevant; they only keep the host-side FFT/Σ precompute finite."""
    import jax

    n = stop - start
    if jax.process_count() == 1 or not hasattr(eng, "owned_image_rows"):
        return source.chunk(start, stop)
    ranges = []
    for a, b in eng.owned_image_rows():
        a = max(a, 0)
        b = min(b, n)  # owned ranges are in padded-capacity rows
        if a < b:
            ranges.append((a, b))
    if not ranges:  # this process owns only padding rows of a short chunk
        ranges = [(0, 1)]
    first = source.chunk(start + ranges[0][0], start + ranges[0][1])
    maps = np.broadcast_to(first[:1], (n,) + first.shape[1:]).copy()
    maps[ranges[0][0]:ranges[0][1]] = first
    for a, b in ranges[1:]:
        maps[a:b] = source.chunk(start + a, start + b)
    return maps


def run_streaming(
    p,
    orients,
    model,
    source: ImageSource,
    cfg: Optional[RunConfig] = None,
    chunk_images: int = 1024,
    progress: bool = False,
) -> tuple[Results, dict]:
    """Full posterior over an image set streamed in chunks.

    Returns (results, perf) with results identical (same values) to a
    non-streamed run over the whole set — per-image state makes cross-chunk
    merging exact concatenation. With ``cfg.mesh_images``/``cfg.mesh_orient``
    > 1 each chunk runs on the device mesh (sharded engine); under
    multi-host execution each process reads only its image shards.

    Checkpointing composes: each chunk checkpoints to its own file
    (``cfg.checkpoint_path + '.chunk<k>'``) under a fingerprint tied to the
    chunk's image range, so a restarted run resumes chunk-accurate — a
    completed earlier chunk is loaded, never recomputed, and never
    mistaken for a later chunk's result.
    """
    import time
    from concurrent.futures import ThreadPoolExecutor

    from .run import make_engine

    cfg = cfg or RunConfig()
    n_total = source.n_images
    chunk_images = min(chunk_images, n_total)
    eng: Optional[BioEMEngine] = None
    parts: list[Results] = []
    perf = {"run_s": 0.0, "comparisons": 0, "chunks": 0}
    spans = [
        (s, min(s + chunk_images, n_total))
        for s in range(0, n_total, chunk_images)
    ]

    # One-chunk-ahead prefetch: the host-side read + normalisation + FFT
    # precompute (_image_arrays) of chunk k+1 overlaps chunk k's device
    # scan (the reference overlaps H2D with compute the same way via its
    # async pipeline, bioem_cuda.cu:527-566); only device placement stays
    # on the main thread. The ingest sources are thread-safe
    # (MRCStackSource opens its own handle per read; ArraySource slices an
    # in-RAM array), and _image_arrays only reads engine constants.
    def _prepare(start: int, stop: int):
        return eng._image_arrays(_read_chunk_local(source, start, stop, eng))

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None
        banks_next = None
        for ci, (start, stop) in enumerate(spans):
            if eng is None:
                # First chunk is read fully on every process: engine
                # construction hashes images[:1] into the checkpoint
                # fingerprint, which must be process-independent.
                maps = source.chunk(start, stop)
                eng = make_engine(p, orients, model, ImageStack(maps), cfg)
                banks = eng.banks
            else:
                banks = (
                    banks_next
                    if banks_next is not None
                    else eng._place_banks(_prepare(start, stop))
                )
            if ci + 1 < len(spans) and pending is None:
                pending = pool.submit(_prepare, *spans[ci + 1])
            ckpt = (
                f"{cfg.checkpoint_path}.chunk{ci}" if cfg.checkpoint_path else None
            )
            t0 = time.perf_counter()
            state = eng.run(
                banks=banks,
                bank_tag=f"images[{start}:{stop}]",
                checkpoint_path=ckpt,
            )
            # run() dispatches the device scan asynchronously; while it
            # executes, finish the next chunk's host precompute AND its
            # device placement — H2D now rides under chunk ci's compute
            # (the reference's async pipeline does the same with
            # cudaMemcpyAsync + events, bioem_cuda.cu:527-566). Two chunk
            # banks are resident during the overlap; results() below is the
            # only synchronisation point.
            if ci + 1 < len(spans):
                banks_next = eng._place_banks(pending.result())
                pending = (
                    pool.submit(_prepare, *spans[ci + 2])
                    if ci + 2 < len(spans)
                    else None
                )
            parts.append(eng.results(state, n_img=stop - start))
            dt = time.perf_counter() - t0
            perf["run_s"] += dt
            perf["comparisons"] += (stop - start) * eng.n_orient * eng.n_ctf
            perf["chunks"] += 1
            if progress:
                print(
                    f"chunk {perf['chunks']}: images [{start}, {stop}) in {dt:.2f}s "
                    f"({(stop - start) * eng.n_orient * eng.n_ctf / dt:.3e} cmp/s)"
                )
    return _concat_results(parts), perf
