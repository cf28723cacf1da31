"""Single-device BioEM engine: precompute → jitted orientation-block scan.

JAX re-design of the reference main loop (``bioem::run``,
/root/reference/bioem.cpp:659-907). The reference's triple loop
(orientation × ctf × image) with OpenMP/CUDA double-buffering becomes:

* host-side precompute of the CTF bank, image FFT bank, per-image sums and
  DFT displacement weights (reference precalculate, bioem.cpp:594-622);
* one jitted **block step** that projects an orientation block, convolves
  with the whole CTF bank, evaluates the displacement-lattice posterior for
  every image and folds it into the streaming per-image state;
* a ``lax.scan`` (or host loop, for progress output) over orientation
  blocks — XLA pipelines projection/convolution/comparison automatically,
  subsuming the reference's manual 2-stage pipeline (bioem.cpp:708-726).

Multi-device sharding wraps this engine via shard_map (bioem_tpu.parallel).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import defs
from ..config import RunConfig
from ..params import (
    BioEMParams,
    displacement_lists,
    log_normalization_constant,
    make_ctf_grid,
    orientation_volume_quirked,
)
from ..io.map_io import ImageStack
from ..io.model_io import Model
from .ctf import build_ctf_bank
from .orientations import OrientationSet, rotation_matrices
from .posterior import (
    PosteriorState,
    convolution_sums,
    ctf_prior_term,
    displacement_cc,
    displacement_dft_weights,
    displacement_lse,
    hermitian_weights,
    init_state,
    logpro_constants,
    merge_block,
)
from .projection import (
    make_fourier_projection_spec,
    make_projection_spec,
    project_batch,
    project_fourier_batch,
    projection_always_in_bounds,
    projection_oob_report,
)

F32 = jnp.float32
F64 = jnp.float64
I32 = jnp.int32


class Banks(NamedTuple):
    """Device-resident precomputed constants, passed explicitly to the
    jitted step (closure capture would embed them as MLIR constants, which
    both bloats the executable and requires device→host copies that some
    PJRT backends forbid)."""

    ctf_re: jnp.ndarray  # (C, N, F) f32 CTF/PSF kernel bank (real part)
    ctf_im: jnp.ndarray
    wx_re: jnp.ndarray  # (D, N) f32 displacement DFT rows
    wx_im: jnp.ndarray
    wy_re: jnp.ndarray  # (D, F) f32 displacement DFT cols
    wy_im: jnp.ndarray
    h: jnp.ndarray  # (F,) f32 Hermitian weights
    img_re: jnp.ndarray  # (I, N, F) f32 conj image spectra · h/N² (real)
    img_im: jnp.ndarray
    sum_ref: jnp.ndarray  # (I,) f32
    ssq_ref: jnp.ndarray  # (I,) f32
    disp: jnp.ndarray  # (D,) i32
    amp: jnp.ndarray  # (C,) f32
    pha: jnp.ndarray
    env: jnp.ndarray
    points: jnp.ndarray  # (P, 3) f32 (radius-sorted when Fourier projection)
    radii: jnp.ndarray  # (P,) f32
    dens: jnp.ndarray  # (P,) f32
    norm_den: jnp.ndarray  # scalar f32
    st_re: jnp.ndarray  # (U, N, F) f32 radius-group stencil DFTs (Fourier
    st_im: jnp.ndarray  # projection path; (1, 1, 1) dummies otherwise)
    st_sums: jnp.ndarray  # (U,) f32 unit-stencil sums (tempden weights)


@dataclass
class Results:
    """Final per-image posterior summary (reference Output_Probabilities)."""

    log_prob: np.ndarray
    constoadd: np.ndarray
    total: np.ndarray
    best_orient: np.ndarray
    best_conv: np.ndarray
    best_cent_x: np.ndarray
    best_cent_y: np.ndarray
    best_norm: np.ndarray
    best_mu: np.ndarray
    angle_log: Optional[np.ndarray]  # (I, n_orient) or None
    log_norm_const: float
    # raw per-angle accumulator split for ANG_PROB's "Separated:" columns:
    # (log(forAngles), ConstAngle) per (image, orientation)
    angle_raw: Optional[tuple] = None
    # CTF parameter grid, attached by the driver for the output writers
    grid: Optional[object] = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BioEMEngine:
    """Posterior computation for one model against an image stack."""

    def __init__(
        self,
        p: BioEMParams,
        orients: OrientationSet,
        model: Model,
        images: ImageStack,
        cfg: Optional[RunConfig] = None,
        model_layout: Optional[dict] = None,
    ):
        """``model_layout`` pads the model-dependent array shapes to a common
        layout so one compiled step can serve several models via
        :meth:`swap_model` (multi-model ranking, reference MODEL_COMPARISON
        workflow doc/index.rst:2290-2521). Keys: ``n_points_pad``,
        ``n_groups_pad``, ``group_pad``, ``stencil_half``, ``force_raster``."""
        defs.enable_x64()
        cfg = cfg or RunConfig()
        self.cfg = cfg
        self.p = p
        lay = model_layout or {}
        self._n_points_pad = int(lay.get("n_points_pad", 0))
        self._g_pad = int(lay.get("n_groups_pad", 0))
        self._pp_pad = int(lay.get("group_pad", 0))
        self._stencil_half_min = int(lay.get("stencil_half", 0))
        self._force_raster = bool(lay.get("force_raster", False))

        # Debug reductions (reference bioem.cpp:518-525, map.cpp:545-548)
        grid = make_ctf_grid(p)
        n_orient = orients.n
        n_ctf = grid.n
        if cfg.debug_break:
            n_orient = min(n_orient, cfg.debug_break)
            n_ctf = min(n_ctf, cfg.debug_break)
        maps = images.maps
        if cfg.debug_nmaps:
            maps = maps[: cfg.debug_nmaps]

        self.orients = orients
        self.n_orient = n_orient
        self.n_img = maps.shape[0]
        n = p.n_pixels
        nf = p.n_fft_1d

        # --- CTF bank (host precompute, reference param.cpp:1336-1620) ---
        self.grid = grid
        ctf_bank = build_ctf_bank(p, grid)[:n_ctf]
        self.n_ctf = n_ctf

        # --- displacement lattice + DFT weights ---
        disp, _cent = displacement_lists(p)
        self.disp = disp
        wx, wy = displacement_dft_weights(n, disp)

        self._h = hermitian_weights(n)

        # --- block sizes ---
        self.o_block = max(1, min(cfg.orient_block, n_orient))
        if cfg.image_block > 0:
            self.i_block = min(cfg.image_block, self.n_img)
        else:
            # Bound the (O, C, Ib, N, F) complex64 product tensor ≈ 1 GiB.
            budget = 1 << 27  # elements
            per_img = self.o_block * n_ctf * n * nf
            self.i_block = int(np.clip(budget // max(per_img, 1), 1, self.n_img))
        img_mult = self.i_block * getattr(self, "n_img_shards", 1)
        self.n_img_pad = _cdiv(self.n_img, img_mult) * img_mult

        blk_mult = self.o_block * getattr(self, "n_orient_shards", 1)
        self.n_orient_pad = _cdiv(n_orient, blk_mult) * blk_mult

        # --- image precompute (reference map.cpp:557-630) ---
        img = self._image_arrays(maps)

        # --- model precompute (projection layout, see _model_arrays) ---
        self.fspec = None
        self.spec = None
        marr = self._model_arrays(model, first=True)

        # --- device constants (explicit jit arguments, see Banks) ---
        # Complex banks are shipped as split real/imag float32: every
        # contraction in the block step is a real f32 matmul.
        self.banks = Banks(
            ctf_re=jnp.asarray(np.ascontiguousarray(ctf_bank.real)),
            ctf_im=jnp.asarray(np.ascontiguousarray(ctf_bank.imag)),
            wx_re=jnp.asarray(np.ascontiguousarray(wx.real)),
            wx_im=jnp.asarray(np.ascontiguousarray(wx.imag)),
            wy_re=jnp.asarray(np.ascontiguousarray(wy.real)),
            wy_im=jnp.asarray(np.ascontiguousarray(wy.imag)),
            h=jnp.asarray(self._h),
            disp=jnp.asarray(disp.astype(np.int32)),
            amp=jnp.asarray(grid.amp[:n_ctf]),
            pha=jnp.asarray(grid.phase[:n_ctf]),
            env=jnp.asarray(grid.env[:n_ctf]),
            **{k: jnp.asarray(v) for k, v in {**img, **marr}.items()},
        )

        # --- orientation blocks (padded; mask kills padding lanes) ---
        ang = orients.angles[:n_orient]
        pad_o = self.n_orient_pad - n_orient
        ang_p = np.concatenate([ang, np.repeat(ang[:1], pad_o, 0)]) if pad_o else ang
        mask = np.concatenate(
            [np.ones(n_orient, np.int32), np.zeros(pad_o, np.int32)]
        )
        nblk = self.n_orient_pad // self.o_block
        self._ang = ang
        self.ang_blocks = jnp.asarray(
            ang_p.reshape(nblk, self.o_block, 4).astype(np.float32)
        )
        self.mask_blocks = jnp.asarray(mask.reshape(nblk, self.o_block))
        self.offsets = jnp.asarray(
            (np.arange(nblk) * self.o_block).astype(np.int32)
        )

        self._check_projection_bounds(model)

        self._step = jax.jit(self._block_step, donate_argnums=(0,))
        self._scan_run = jax.jit(self._run_scan, donate_argnums=(0,))

        # Always computed (cheap: one sha256 over the small identifying
        # arrays) — run() may enable checkpointing per-call via its
        # checkpoint_path override even when cfg.checkpoint_path is empty.
        from ..runtime.checkpoint import problem_fingerprint

        self._fingerprint = problem_fingerprint(p, orients, model, images, cfg)

    # ------------------------------------------------------------------
    # Bank builders. Image and model data enter the jitted step as explicit
    # arguments (Banks), so swapping either reuses the compiled step with
    # zero retracing as long as the array shapes match — the basis of the
    # multi-model ranking driver (rank.py) and the image-streaming mode
    # (stream.py; the reference's GPU image chunking, map.cpp:549).
    # ------------------------------------------------------------------
    def _image_arrays(self, maps: np.ndarray) -> dict:
        """Per-image Σ/Σ² and prefolded conj-FFT bank, padded to n_img_pad
        (reference map.cpp:557-630)."""
        n = self.p.n_pixels
        n_img = maps.shape[0]
        if n_img > self.n_img_pad:
            raise ValueError(f"{n_img} images exceed engine capacity {self.n_img_pad}")
        flat = maps.reshape(n_img, -1).astype(np.float64)
        sum_ref = flat.sum(axis=1).astype(np.float32)
        ssq_ref = (flat**2).sum(axis=1).astype(np.float32)
        # Data-driven gate for the f32 log1p shortcut in logpro_constants:
        # the shortcut needs h/g = (sr²/ssr)/g ≲ 1e-4 per image; with
        # g = ntot − sc²/ssc ≳ ntot/2 that bounds to h_max < 5e-5·ntot.
        # Normalised ingest gives h ≈ 1e-9; TEXT maps are never normalised
        # (reference parity) and a DC-dominated text image has h ~ ntot,
        # where the f32 path would shift K by whole log-units. The gate is
        # trace-time static, so swapped image chunks must stay on the same
        # side (checked below).
        h_max = float(
            np.max(sum_ref.astype(np.float64) ** 2
                   / np.maximum(ssq_ref.astype(np.float64), 1e-300))
        ) if n_img else 0.0
        f32_ok = (not self.p.no_map_norm) and (
            h_max < 5e-5 * self.p.n_total_pixels
        )
        if not hasattr(self, "_f32_corr_ok"):
            self._f32_corr_ok = f32_ok
        elif self._f32_corr_ok and not f32_ok:
            raise ValueError(
                "swap_images: this image chunk has DC-dominated images "
                f"(max sum²/sumsq = {h_max:.3g}) but the engine was "
                "compiled with the f32 log1p shortcut for near-zero-mean "
                "images; rebuild the engine with (a chunk of) these images "
                "so the f64 correction path is compiled in"
            )
        img_fft = np.fft.rfft2(maps.astype(np.float32)).astype(np.complex64)
        img_fc = (
            np.conj(img_fft) * (self._h[None, None, :] / np.float32(n * n))
        ).astype(np.complex64)
        pad_i = self.n_img_pad - n_img
        if pad_i:
            # Replicate image 0 into the padding lanes to keep all values
            # finite; padded lanes are dropped at extraction time.
            img_fc = np.concatenate([img_fc, np.repeat(img_fc[:1], pad_i, 0)])
            sum_ref = np.concatenate([sum_ref, np.repeat(sum_ref[:1], pad_i)])
            ssq_ref = np.concatenate([ssq_ref, np.repeat(ssq_ref[:1], pad_i)])
        return dict(
            img_re=np.ascontiguousarray(img_fc.real),
            img_im=np.ascontiguousarray(img_fc.imag),
            sum_ref=sum_ref,
            ssq_ref=ssq_ref,
        )

    def _model_arrays(self, model: Model, first: bool = False) -> dict:
        """Model point/stencil arrays in the engine's fixed projection
        layout. On ``first=True`` establishes self.fspec/self.spec; later
        calls (swap_model) must land on the same static layout."""
        p = self.p
        cfg = self.cfg
        fspec = None
        pts = model.points
        radii = model.radii
        dens = model.densities
        st_re = st_im = np.zeros((1, 1, 1), np.float32)
        st_sums = np.zeros(1, np.float32)
        # Fourier-space projection: exact, raster+FFT-free; needs few
        # distinct radii (see projection.py). Falls back to the raster.
        if cfg.projection in ("auto", "fourier") and not self._force_raster:
            fp = make_fourier_projection_spec(
                p, model.radii, n_groups_pad=self._g_pad, group_pad=self._pp_pad
            )
            if fp is not None:
                fspec, gather_idx, pad_mask, st, st_sums = fp
                pts = model.points[gather_idx]
                radii = model.radii[gather_idx]
                # Group-padding slots carry zero density → contribute nothing.
                dens = model.densities[gather_idx] * pad_mask
                st_re = np.ascontiguousarray(st.real)
                st_im = np.ascontiguousarray(st.imag)
            elif cfg.projection == "fourier":
                raise ValueError(
                    "projection='fourier' requires <= 32 distinct radii"
                )
        spec = make_projection_spec(
            p, model.radii, stencil_half_min=self._stencil_half_min
        )
        if fspec is None and self._n_points_pad:
            pad = self._n_points_pad - pts.shape[0]
            if pad < 0:
                raise ValueError(
                    f"model has {pts.shape[0]} points > layout pad "
                    f"{self._n_points_pad}"
                )
            if pad:
                # Zero-density pad points contribute nothing to the raster.
                pts = np.concatenate([pts, np.repeat(pts[:1], pad, 0)])
                radii = np.concatenate([radii, np.repeat(radii[:1], pad)])
                dens = np.concatenate([dens, np.zeros(pad, dens.dtype)])
        if first:
            self.fspec = fspec
            self.spec = spec
        else:
            if (fspec is None) != (self.fspec is None) or (
                fspec is not None and fspec != self.fspec
            ):
                raise ValueError(
                    "swap_model: model needs a different Fourier-projection "
                    "layout than this engine was compiled for — pass a "
                    "common model_layout at engine construction (see "
                    "rank.common_model_layout)"
                )
            if fspec is None and spec != self.spec:
                raise ValueError(
                    "swap_model: model needs a different raster stencil than "
                    "this engine was compiled for — pass model_layout with "
                    f"stencil_half >= {spec.stencil_half}"
                )
        return dict(
            points=np.asarray(pts, np.float32),
            radii=np.asarray(radii, np.float32),
            dens=np.asarray(dens, np.float32),
            norm_den=np.float32(model.norm_den),
            st_re=st_re,
            st_im=st_im,
            st_sums=np.asarray(st_sums, np.float32),
        )

    def _place_banks(self, host_fields: dict) -> Banks:
        """Device placement of swapped bank fields (sharded engines
        override to honour their sharding specs)."""
        return self.banks._replace(
            **{k: jnp.asarray(v) for k, v in host_fields.items()}
        )

    def swap_model(self, model: Model) -> Banks:
        """Banks with this engine's precompute but ``model``'s arrays —
        same shapes ⇒ the jitted step is reused without recompiling."""
        self._check_projection_bounds(model)
        return self._place_banks(self._model_arrays(model))

    def swap_images(self, maps: np.ndarray) -> Banks:
        """Banks with this engine's precompute but a new image chunk
        (padded to the engine's image capacity)."""
        return self._place_banks(self._image_arrays(maps))

    def _check_projection_bounds(self, model: Model):
        """Out-of-frame diagnostics (reference bioem.cpp:1723-1731 warns per
        projection; the jitted raster silently zeroes the weights, and a
        fully out-of-frame orientation gives tempden == 0 → NaN). The O(P)
        rotation-invariant bound skips the scan for well-centred models."""
        p = self.p
        n = p.n_pixels
        if projection_always_in_bounds(
            n, p.pixel_size, p.shift_x, p.shift_y, model.points, model.radii
        ):
            return
        rotm_all = np.asarray(
            rotation_matrices(
                jnp.asarray(self._ang.astype(np.float32)),
                self.orients.use_quaternions,
            )
        )
        total_oob, affected, all_oob = projection_oob_report(
            n, p.pixel_size, p.shift_x, p.shift_y,
            model.points, model.radii, rotm_all,
        )
        if all_oob:
            raise ValueError(
                f"model projects entirely outside the {n}x{n} grid for "
                f"{all_oob} of {self.n_orient} orientations (tempden == 0 — "
                "the posterior would be NaN). Check PIXEL_SIZE / "
                "NUMBER_PIXELS / SHIFT_X/Y against the model extent."
            )
        if total_oob:
            warnings.warn(
                f"{total_oob} point projections fall outside the "
                f"{n}x{n} grid across {affected} of {self.n_orient} "
                "orientations; their density is dropped (reference "
                "bioem.cpp:1723-1731 behaviour).",
                RuntimeWarning,
                stacklevel=2,
            )

    # ------------------------------------------------------------------
    def _project_block(self, banks: Banks, angles):
        """Projection spectra (pr, pi) of one orientation block — the front
        half of the block step, shared with the DEBUG_PROB dump path."""
        rotm = rotation_matrices(angles, self.orients.use_quaternions)
        if self.fspec is not None:
            pr, pi = project_fourier_batch(
                self.fspec, rotm, banks.points, banks.radii, banks.dens,
                banks.norm_den, banks.st_re, banks.st_im, banks.st_sums,
            )
        else:
            proj = project_batch(
                self.spec, rotm, banks.points, banks.radii, banks.dens, banks.norm_den
            )
            proj_f = jnp.fft.rfft2(proj)  # (O, N, F) complex — device-internal
            pr, pi = jnp.real(proj_f).astype(F32), jnp.imag(proj_f).astype(F32)
        return pr, pi

    def _block_step(self, state: PosteriorState, banks: Banks, angles, orient_offset, mask, ang_offset=None):
        p = self.p
        n = p.n_pixels
        ntot = p.n_total_pixels

        # Named scopes label the layers in profiler traces
        # (tools/trace_step.py); they do not change the computation.
        with jax.named_scope("project"):
            pr, pi = self._project_block(banks, angles)

        with jax.named_scope("convolve"):
            prior = ctf_prior_term(banks.amp, banks.pha, banks.env, p)  # (C,) f64
            # conv = proj · conj(ctf) (reference bioem.cpp:1879-1883), split form
            conv_re = pr[:, None] * banks.ctf_re[None] + pi[:, None] * banks.ctf_im[None]
            conv_im = pi[:, None] * banks.ctf_re[None] - pr[:, None] * banks.ctf_im[None]
            sum_c, ssq_c = convolution_sums(conv_re, conv_im, banks.h, n)
            prior_oc = jnp.broadcast_to(prior[None, :], sum_c.shape)

        def per_img_block(args):
            img_re_b, img_im_b, sref_b, ssref_b = args
            with jax.named_scope("constants"):
                f0, k = logpro_constants(
                    sum_c, ssq_c, sref_b, ssref_b, prior_oc, ntot,
                    images_normalized=self._f32_corr_ok,
                )
            cc = displacement_cc(
                conv_re, conv_im, img_re_b, img_im_b,
                banks.wx_re, banks.wx_im, banks.wy_re, banks.wy_im,
            )
            with jax.named_scope("lse"):
                m, se, ds, ccs = displacement_lse(
                    cc, sum_c, sref_b, f0, ntot, f32_u=self._f32_corr_ok,
                    ssq_c=ssq_c, ssq_ref=ssref_b,
                )
            return m, se, ds, ccs, k

        n_img_local = banks.img_re.shape[0]
        nb = n_img_local // self.i_block
        xs = (
            banks.img_re.reshape(nb, self.i_block, n, p.n_fft_1d),
            banks.img_im.reshape(nb, self.i_block, n, p.n_fft_1d),
            banks.sum_ref.reshape(nb, self.i_block),
            banks.ssq_ref.reshape(nb, self.i_block),
        )
        m, se, ds, ccs, k = jax.lax.map(per_img_block, xs)
        # (B, O, C, Ib, ...) → (O, C, I)
        o, c = self.o_block, self.n_ctf

        def fold(x):
            return jnp.moveaxis(x, 0, 2).reshape(o, c, n_img_local)

        m, se, ds, ccs = fold(m), fold(se), fold(ds), fold(ccs)
        k = fold(k)
        k = jnp.where(mask[:, None, None] != 0, k, -jnp.inf)

        with jax.named_scope("merge"):
            return merge_block(
                state, m, se, ds, ccs, k, sum_c, ssq_c, banks.sum_ref,
                banks.disp, orient_offset, ntot, self.disp.shape[0],
                ang_offset=ang_offset,
            )

    def _run_scan(self, state, banks, ang_blocks, offsets, mask_blocks):
        def body(st, xs):
            ang, off, mask = xs
            return self._block_step(st, banks, ang, off, mask), None

        state, _ = jax.lax.scan(body, state, (ang_blocks, offsets, mask_blocks))
        return state

    def time_blocks(self, target_orients: int, repeats: int = 2) -> float:
        """Best-of-``repeats`` seconds per orientation of the jitted scan
        path over ~``target_orients`` orientations (autotuner probe; first
        pass includes compile and is dropped). Times the SCAN, not eager
        per-block steps — eager timing adds a host dispatch per block, which
        systematically favours big orient_blocks."""
        import time

        nb = min(
            max(1, _cdiv(target_orients, self.o_block)), self.ang_blocks.shape[0]
        )
        ang = self.ang_blocks[:nb]
        off = self.offsets[:nb]
        msk = self.mask_blocks[:nb]
        best = float("inf")
        for _ in range(repeats + 1):
            state = self.initial_state()
            t0 = time.perf_counter()
            state = self._scan_run(state, self.banks, ang, off, msk)
            jax.block_until_ready(state.total)
            best = min(best, time.perf_counter() - t0)
        return best / (nb * self.o_block)

    # ------------------------------------------------------------------
    def initial_state(self) -> PosteriorState:
        return init_state(self.n_img_pad, self.n_orient_pad, self.p.write_angles > 0)

    def _checkpoint_fingerprint(self, banks, bank_tag: str) -> str:
        """Fingerprint for this run's checkpoint, tied to the ACTIVE banks.

        The construction-time fingerprint alone is wrong under
        swap_images/swap_model: chunk 2 of a streamed run would silently
        load chunk 1's completed checkpoint (same path, same fingerprint)
        and return chunk 1's posterior for chunk 2's images. Swapped banks
        therefore must carry a caller-supplied identity tag; refusing
        loudly beats corrupting results (reference state-init contract,
        bioem.cpp:681-699: every run starts from ITS inputs)."""
        if banks is self.banks:
            return self._fingerprint
        if not bank_tag:
            raise ValueError(
                "checkpointing with swapped banks requires a bank_tag "
                "identifying the active image chunk / model (see "
                "stream.py / rank.py) — without one, a completed "
                "checkpoint from a previous bank would be silently "
                "loaded as this bank's result"
            )
        return f"{self._fingerprint}|bank:{bank_tag}"

    def run(
        self,
        progress: bool = False,
        banks: Optional[Banks] = None,
        bank_tag: str = "",
        checkpoint_path: Optional[str] = None,
    ) -> PosteriorState:
        """One full posterior pass. ``banks`` overrides the engine's banks
        (swap_model/swap_images) — same shapes reuse the compiled step.
        ``bank_tag`` identifies swapped banks for checkpointing;
        ``checkpoint_path`` overrides cfg.checkpoint_path (per-chunk files
        in streaming mode)."""
        if banks is None:
            banks = self.banks
        state = self.initial_state()
        ckpt = checkpoint_path if checkpoint_path is not None else self.cfg.checkpoint_path
        fingerprint = self._checkpoint_fingerprint(banks, bank_tag) if ckpt else ""
        if ckpt or progress or self.cfg.debug_output >= 1:
            import time

            from ..utils.timestat import TimeStat

            ts = TimeStat()
            nblk = self.ang_blocks.shape[0]
            start_block = 0
            if ckpt:
                from ..runtime.checkpoint import load_checkpoint, save_checkpoint

                loaded = load_checkpoint(ckpt, fingerprint)
                if loaded is not None:
                    state, start_block = loaded
                    if self.cfg.debug_output >= 1:
                        print(f"Resuming from checkpoint at block {start_block}/{nblk}")
                every = max(1, self.cfg.checkpoint_every or 16)
            for b in range(start_block, nblk):
                with ts.time("BLOCK"):
                    state = self._step(
                        state, banks, self.ang_blocks[b], self.offsets[b],
                        self.mask_blocks[b],
                    )
                    if self.cfg.debug_output >= 2 or (
                        ckpt and ((b + 1) % every == 0 or b == nblk - 1)
                    ):
                        jax.block_until_ready(state.total)
                if self.cfg.debug_output >= 2:
                    print(
                        f"\tTime orientation block {b}/{nblk}: "
                        f"{ts.phases['BLOCK'][-1]:.4f}"
                    )
                if ckpt and ((b + 1) % every == 0 or b == nblk - 1):
                    with ts.time("CHECKPOINT"):
                        host = PosteriorState(
                            *(np.asarray(v) if v is not None else None for v in state)
                        )
                        save_checkpoint(ckpt, host, b + 1, fingerprint)
            if self.cfg.debug_output >= 1 and ts.phases:
                print(ts.summary())
            return state
        return self._scan_run(
            state, banks, self.ang_blocks, self.offsets, self.mask_blocks
        )

    # ------------------------------------------------------------------
    def results(self, state: PosteriorState, n_img: Optional[int] = None) -> Results:
        # to_host_global makes this multi-host-safe: each field is
        # allgathered across processes before the host-side math (the
        # analogue of the reference's MPI_Reduce to rank 0, bioem.cpp:935).
        # ``n_img`` overrides the slice for streamed image chunks shorter
        # than the engine's capacity (stream.py).
        from ..parallel.distributed import to_host_global

        p = self.p
        volu = orientation_volume_quirked(p, self.orients.voluang, self.grid)
        k_norm = log_normalization_constant(p, volu)
        i = self.n_img if n_img is None else n_img
        total = to_host_global(state.total)[:i]
        const = to_host_global(state.const)[:i]
        with np.errstate(divide="ignore"):
            log_prob = np.log(total) + const + k_norm
        angle_log = None
        angle_raw = None
        if state.ang_total is not None:
            at = to_host_global(state.ang_total)[:i, : self.n_orient]
            ac = to_host_global(state.ang_const)[:i, : self.n_orient]
            with np.errstate(divide="ignore"):
                log_at = np.log(at)
                angle_log = log_at + ac + k_norm
            angle_raw = (log_at, ac)
        return Results(
            log_prob=log_prob,
            constoadd=const,
            total=total,
            best_orient=to_host_global(state.best_orient)[:i],
            best_conv=to_host_global(state.best_conv)[:i],
            best_cent_x=to_host_global(state.best_cent_x)[:i],
            best_cent_y=to_host_global(state.best_cent_y)[:i],
            best_norm=to_host_global(state.best_norm)[:i],
            best_mu=to_host_global(state.best_mu)[:i],
            angle_log=angle_log,
            log_norm_const=k_norm,
            angle_raw=angle_raw,
        )
