"""Multi-device execution over a 2-D (images × orientations) mesh.

JAX replacement for the reference's MPI layer
(/root/reference/main.cpp:64-68, bioem.cpp:453-503, 748-753, 909-1044):

* the reference's rank-sliced orientation loop (P1) → orientation blocks
  sharded over the ``orient`` mesh axis via shard_map;
* the reference's OpenMP image parallelism (P2) → images sharded over the
  ``img`` mesh axis (each shard holds its image FFT bank and its slice of
  the streaming posterior state);
* the end-of-run MPI max/rescale/sum reduction + argmax shipping → one
  collective log-sum-exp (`merge_across_orient`), which XLA lowers to
  NCCL all-reduces over NVLink between the cards of a host.

The main loop is communication-free, exactly like the reference: shards
work independently between setup and the single final collective.

Multi-host: initialise jax.distributed before constructing the engine and
pass the global mesh; per-host ingest feeds the shards it owns.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RunConfig
from ..core.engine import Banks, BioEMEngine, Results, _cdiv
from ..core.posterior import PosteriorState, init_state, merge_across_orient
from ..io.map_io import ImageStack
from ..io.model_io import Model
from .distributed import put_sharded, to_host_global


def make_bioem_mesh(n_img_shards: int, n_orient_shards: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_img_shards * n_orient_shards
    if len(devices) < need:
        raise ValueError(f"Mesh {n_img_shards}×{n_orient_shards} needs {need} devices, "
                         f"have {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(n_img_shards, n_orient_shards)
    return Mesh(dev, axis_names=("img", "orient"))


class ShardedBioEMEngine(BioEMEngine):
    """BioEMEngine running under shard_map on an (img, orient) mesh."""

    def __init__(
        self,
        p,
        orients,
        model: Model,
        images: ImageStack,
        cfg: Optional[RunConfig] = None,
        mesh: Optional[Mesh] = None,
        model_layout: Optional[dict] = None,
    ):
        cfg = cfg or RunConfig()
        self.mesh = mesh or make_bioem_mesh(cfg.mesh_images, cfg.mesh_orient)
        self.n_img_shards = self.mesh.shape["img"]
        self.n_orient_shards = self.mesh.shape["orient"]
        super().__init__(p, orients, model, images, cfg, model_layout=model_layout)
        self._build_sharded()

    def owned_image_rows(self) -> list:
        """Global [start, stop) row ranges of the padded image axis whose
        shards live on THIS process' devices — the per-host ingest contract
        (each process reads only the particle images it will compute on,
        like each MPI rank chunking its own images through its GPU,
        reference map.cpp:549 + bioem.cpp:748-753)."""
        from jax.sharding import NamedSharding

        sharding = NamedSharding(self.mesh, P("img"))
        imap = sharding.addressable_devices_indices_map((self.n_img_pad,))
        spans = set()
        for idx in imap.values():
            sl = idx[0]
            spans.add((sl.start or 0, self.n_img_pad if sl.stop is None else sl.stop))
        merged = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(b, merged[-1][1]))
            else:
                merged.append((a, b))
        return merged

    # ------------------------------------------------------------------
    def _build_sharded(self):
        mesh = self.mesh
        img_spec = P("img")
        rep = P()

        img_sharded = {"img_re", "img_im", "sum_ref", "ssq_ref"}
        self.banks_specs = Banks(
            **{f: (img_spec if f in img_sharded else rep) for f in Banks._fields}
        )
        state_specs = PosteriorState(
            total=img_spec,
            const=img_spec,
            best_orient=img_spec,
            best_conv=img_spec,
            best_cent_x=img_spec,
            best_cent_y=img_spec,
            best_norm=img_spec,
            best_mu=img_spec,
            ang_total=P("img", "orient") if self.p.write_angles else None,
            ang_const=P("img", "orient") if self.p.write_angles else None,
        )
        blk_spec = P("orient")  # leading block axis sharded over orientations

        n_blk = self.ang_blocks.shape[0]
        blocks_per_shard = n_blk // self.n_orient_shards
        o_per_shard = blocks_per_shard * self.o_block

        self._state_specs = state_specs
        self._sharded_run = self._make_sharded_scan(blocks_per_shard, blk_spec)

        # --- chunked runner for checkpoint/resume ---------------------------
        # The single-call scan above cannot checkpoint mid-run; with a
        # checkpoint path configured, the scan is split into uniform chunks
        # of per-shard blocks, with the collective merge deferred to one
        # final merge-only call (merging between chunks would double-count:
        # after a merge every orientation shard holds the global state).
        #
        # Mid-run, each orientation shard holds DIFFERENT partial accumulators
        # for the same image, so the per-image state fields cannot use the
        # replicated-over-orient spec P("img") (a host round-trip would keep
        # one shard's partials and drop the rest). The chunked state instead
        # carries an explicit leading orient axis: global (n_orient_shards,
        # n_img_pad) with spec P("orient", "img"); the per-angle slabs are
        # already genuinely orient-sharded and keep their spec.
        self._chunks = None

        def build_chunked(every):
            bps = blocks_per_shard
            n_chunks = _cdiv(bps, every)
            bps_pad = n_chunks * every
            ang = np.asarray(self.ang_blocks).reshape(
                self.n_orient_shards, bps, self.o_block, 4
            )
            off = np.asarray(self.offsets).reshape(self.n_orient_shards, bps)
            msk = np.asarray(self.mask_blocks).reshape(
                self.n_orient_shards, bps, self.o_block
            )
            pad = bps_pad - bps
            if pad:
                ang = np.concatenate([ang, np.repeat(ang[:, :1], pad, 1)], axis=1)
                off = np.concatenate([off, np.repeat(off[:, :1], pad, 1)], axis=1)
                msk = np.concatenate(
                    [msk, np.zeros((self.n_orient_shards, pad, self.o_block), msk.dtype)],
                    axis=1,
                )

            def put(x, spec):
                return put_sharded(x, mesh, spec)

            self._chunks = []
            for c in range(n_chunks):
                sl = slice(c * every, (c + 1) * every)
                loff = (
                    (c * every + np.arange(every)) * self.o_block
                ).astype(np.int32)
                self._chunks.append((
                    put(ang[:, sl].reshape(-1, self.o_block, 4), blk_spec),
                    put(off[:, sl].reshape(-1), blk_spec),
                    put(msk[:, sl].reshape(-1, self.o_block), blk_spec),
                    jnp.asarray(loff),
                ))

            stacked = P("orient", "img")
            ang_spec = P("img", "orient") if self.p.write_angles else None
            stacked_specs = PosteriorState(
                total=stacked, const=stacked, best_orient=stacked,
                best_conv=stacked, best_cent_x=stacked, best_cent_y=stacked,
                best_norm=stacked, best_mu=stacked,
                ang_total=ang_spec, ang_const=ang_spec,
            )
            n_ang_fields = 2  # trailing ang_total/ang_const keep their layout

            def unstack(st):
                vals = [v[0] if v is not None else None for v in st[:-n_ang_fields]]
                return PosteriorState(*vals, *st[-n_ang_fields:])

            def restack(st):
                vals = [v[None] if v is not None else None for v in st[:-n_ang_fields]]
                return PosteriorState(*vals, *st[-n_ang_fields:])

            def chunk_fn(state, banks, ang_blocks, offsets, masks, local_off):
                def body(st, xs):
                    a, o, m, lo = xs
                    return (
                        self._block_step(st, banks, a, o, m, ang_offset=lo),
                        None,
                    )

                state, _ = jax.lax.scan(
                    body, unstack(state), (ang_blocks, offsets, masks, local_off)
                )
                return restack(state)

            rep = P()
            self._chunk_run = jax.jit(
                jax.shard_map(
                    chunk_fn,
                    mesh=mesh,
                    in_specs=(stacked_specs, self.banks_specs, blk_spec, blk_spec, blk_spec, rep),
                    out_specs=stacked_specs,
                    check_vma=False,
                ),
                donate_argnums=(0,),
            )
            self._merge_run = jax.jit(
                jax.shard_map(
                    lambda st: merge_across_orient(unstack(st), "orient"),
                    mesh=mesh,
                    in_specs=(stacked_specs,),
                    out_specs=state_specs,
                    check_vma=False,
                ),
                donate_argnums=(0,),
            )
            self._stacked_specs = stacked_specs

        # Kept callable so run() can enable checkpointing per-call (base
        #-class contract) even when cfg.checkpoint_path was empty at
        # construction — the chunked runner is then built lazily.
        self._build_chunked = build_chunked
        if self.cfg.checkpoint_path:
            build_chunked(max(1, self.cfg.checkpoint_every or 16))

        # Host copies of the leading orientation blocks for the autotuner's
        # timing program (time_blocks replays them replicated on every
        # orientation shard — per-shard work identical to production).
        keep = min(32, n_blk)
        self._blk_host = (
            np.asarray(self.ang_blocks[:keep]),
            np.asarray(self.offsets[:keep]),
            np.asarray(self.mask_blocks[:keep]),
        )
        self._timing_runs = {}

        # Place inputs according to their specs so no implicit reshard runs.
        # put_sharded materialises only process-local shards, so this path
        # is multi-host-safe (each host feeds the image shards it owns).
        def put(x, spec):
            return put_sharded(x, mesh, spec)

        self.banks = Banks(
            *(put(v, s) for v, s in zip(self.banks, self.banks_specs))
        )
        self.ang_blocks = put(self.ang_blocks, blk_spec)
        self.offsets = put(self.offsets, blk_spec)
        self.mask_blocks = put(self.mask_blocks, blk_spec)

    # ------------------------------------------------------------------
    def _make_sharded_scan(self, n_blocks: int, blk_in_spec):
        """Jitted shard_map'd scan over ``n_blocks`` per-shard orientation
        blocks followed by the collective orient merge. One factory serves
        both the production run (blk_in_spec = P("orient")) and the
        autotuner's timing probe (replicated blocks, P()) so they can never
        drift apart — a probe timing a different program than production is
        exactly the mistune class time_blocks exists to eliminate."""

        def shard_fn(state, banks, ang_blocks, offsets, masks):
            # Local offsets within this shard's per-angle slab.
            local_off = jnp.arange(n_blocks, dtype=jnp.int32) * self.o_block

            def body(st, xs):
                ang, off, mask, loff = xs
                return (
                    self._block_step(st, banks, ang, off, mask, ang_offset=loff),
                    None,
                )

            state, _ = jax.lax.scan(
                body, state, (ang_blocks, offsets, masks, local_off)
            )
            return merge_across_orient(state, "orient")

        return jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=self.mesh,
                in_specs=(
                    self._state_specs, self.banks_specs,
                    blk_in_spec, blk_in_spec, blk_in_spec,
                ),
                out_specs=self._state_specs,
                check_vma=False,
            ),
            donate_argnums=(0,),
        )

    # ------------------------------------------------------------------
    def _place_banks(self, host_fields: dict) -> Banks:
        """swap_model/swap_images placement honouring the mesh sharding."""
        specs = self.banks_specs._asdict()
        return self.banks._replace(
            **{
                k: put_sharded(np.asarray(v), self.mesh, specs[k])
                for k, v in host_fields.items()
            }
        )

    # ------------------------------------------------------------------
    def initial_state(self) -> PosteriorState:
        st = init_state(self.n_img_pad, self.n_orient_pad, self.p.write_angles > 0)

        def put(x, spec):
            if x is None:
                return None
            return put_sharded(x, self.mesh, spec)

        return PosteriorState(
            *(put(v, s) for v, s in zip(st, self._state_specs))
        )

    def _initial_stacked_state(self) -> PosteriorState:
        st = init_state(self.n_img_pad, self.n_orient_pad, self.p.write_angles > 0)
        # Tile the per-image scalar fields across the leading orient axis
        # (initial state is uniform, so tiling is exact).
        vals = [
            np.broadcast_to(np.asarray(v), (self.n_orient_shards,) + v.shape).copy()
            for v in st[:-2]
        ]
        st = PosteriorState(*vals, *st[-2:])
        return self._put_state(st)

    def _put_state(self, st: PosteriorState) -> PosteriorState:
        def put(x, spec):
            if x is None:
                return None
            return put_sharded(x, self.mesh, spec)

        return PosteriorState(*(put(v, s) for v, s in zip(st, self._stacked_specs)))

    def time_blocks(self, target_orients: int, repeats: int = 2) -> float:
        """Autotuner probe on the mesh: time a shard_map'd scan with every
        orientation shard replaying the SAME leading blocks (replicated
        inputs) — per-shard, per-step work is identical to the production
        sharded scan, so candidate ranking transfers. Returns seconds per
        per-shard orientation (the per-chip cost the tuner minimises)."""
        import time as _time

        nb = min(
            max(1, _cdiv(target_orients, self.o_block)), self._blk_host[0].shape[0]
        )
        if nb not in self._timing_runs:
            self._timing_runs[nb] = self._make_sharded_scan(nb, P())
        fn = self._timing_runs[nb]
        ang = put_sharded(self._blk_host[0][:nb], self.mesh, P())
        off = put_sharded(self._blk_host[1][:nb], self.mesh, P())
        msk = put_sharded(self._blk_host[2][:nb], self.mesh, P())
        best = float("inf")
        for _ in range(repeats + 1):
            state = self.initial_state()
            t0 = _time.perf_counter()
            state = fn(state, self.banks, ang, off, msk)
            jax.block_until_ready(state.total)
            np.asarray(to_host_global(state.total))  # full sync
            best = min(best, _time.perf_counter() - t0)
        return best / (nb * self.o_block)

    def run(
        self,
        progress: bool = False,
        banks: Optional[Banks] = None,
        bank_tag: str = "",
        checkpoint_path: Optional[str] = None,
    ) -> PosteriorState:
        if banks is None:
            banks = self.banks
        ckpt = checkpoint_path if checkpoint_path is not None else self.cfg.checkpoint_path
        if ckpt and self._chunks is None:
            # Per-call checkpoint enable on an engine built without one.
            self._build_chunked(max(1, self.cfg.checkpoint_every or 16))
        if not ckpt:
            state = self.initial_state()
            return self._sharded_run(
                state, banks, self.ang_blocks, self.offsets, self.mask_blocks
            )
        # Chunked path with checkpoint/resume (pre-merge stacked state).
        from ..runtime.checkpoint import load_checkpoint, save_checkpoint

        fingerprint = self._checkpoint_fingerprint(banks, bank_tag)
        start = 0
        state = None
        loaded = load_checkpoint(ckpt, fingerprint)
        if loaded is not None:
            host_state, start = loaded
            state = self._put_state(host_state)
            if self.cfg.debug_output >= 1:
                print(f"Resuming from checkpoint at chunk {start}/{len(self._chunks)}")
        if state is None:
            state = self._initial_stacked_state()
        for c in range(start, len(self._chunks)):
            ang, off, msk, loff = self._chunks[c]
            state = self._chunk_run(state, banks, ang, off, msk, loff)
            jax.block_until_ready(state.total)
            # Multi-host: gather the global state on every host; process 0
            # writes (the file is assumed to live on a shared filesystem,
            # like the reference's MPI-rank-0 output, bioem.cpp:1046).
            host = PosteriorState(*(to_host_global(v) for v in state))
            if jax.process_index() == 0:
                save_checkpoint(ckpt, host, c + 1, fingerprint)
        return self._merge_run(state)
