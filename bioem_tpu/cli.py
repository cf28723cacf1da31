"""Command-line interface with the reference's flag surface.

JAX equivalent of reference ``main.cpp`` + ``bioem::readOptions``
(/root/reference/main.cpp:57-134, bioem.cpp:142-436). All reference long
options are accepted verbatim, so existing BioEM invocations work:

    python -m bioem_tpu.cli --Modelfile m.txt --Particlesfile p.txt \
        --Inputfile params.txt [--ReadOrientation quat.txt] [...]

Performance env vars (BIOEM_DEBUG_*, BIOEM_TPU_*) are honoured via
RunConfig.from_env, mirroring the reference's physics/performance split.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import defs
from .config import RunConfig
from .params import read_best_params, read_parameters
from .io.map_io import read_ref_maps
from .io.model_io import read_model, write_coordread
from .io.output import write_angle_probabilities, write_probabilities


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bioem_tpu",
        description="Bayesian inference of Electron Microscopy images (JAX, GPU)",
        add_help=False,
    )
    # Option table mirrors reference bioem.cpp:193-224.
    ap.add_argument("--Modelfile", metavar="arg", help="(Mandatory) Name of model file")
    ap.add_argument(
        "--Particlesfile", metavar="arg", help="(Mandatory) Name of particle-image file"
    )
    ap.add_argument(
        "--Inputfile", metavar="arg", help="(Mandatory) Name of input parameter file"
    )
    ap.add_argument(
        "--PrintBestCalMap",
        metavar="arg",
        help="(Optional) Only print best calculated map. NO BioEM!",
    )
    ap.add_argument(
        "--ReadOrientation",
        metavar="arg",
        help="(Optional) Read file name containing orientations",
    )
    ap.add_argument(
        "--ReadPDB", action="store_true", help="(Optional) If reading model file in PDB format"
    )
    ap.add_argument(
        "--ReadModelMRC",
        action="store_true",
        help="(Optional) If reading model file in MRC format",
    )
    ap.add_argument(
        "--ReadMRC", action="store_true", help="(Optional) If reading particle file in MRC format"
    )
    ap.add_argument(
        "--ReadMultipleMRC", action="store_true", help="(Optional) If reading multiple MRCs"
    )
    ap.add_argument(
        "--DumpMaps",
        action="store_true",
        help="(Optional) Dump maps after they were read from particle-image file",
    )
    ap.add_argument(
        "--LoadMapDump", action="store_true", help="(Optional) Read maps from dump option"
    )
    ap.add_argument(
        "--DumpModel",
        action="store_true",
        help="(Optional) Dump model after it was read from model file",
    )
    ap.add_argument(
        "--LoadModelDump", action="store_true", help="(Optional) Read model from dump option"
    )
    ap.add_argument(
        "--PrintCOORDREAD", action="store_true", help="(Optional) Print model coordinates"
    )
    ap.add_argument(
        "--OutputFile",
        metavar="arg",
        default=defs.DEFAULT_OUTPUT_FILE,
        help="(Optional) For changing the outputfile name",
    )
    ap.add_argument(
        "--Refine",
        action="store_true",
        help="(Optional, no reference analogue) Continuously refine each "
        "image's maximizing parameters off-grid by autodiff Newton ascent; "
        "writes Output_Refined",
    )
    ap.add_argument(
        "--RefineCTF",
        action="store_true",
        help="(Optional) With --Refine: also refine the CTF phase/envelope",
    )
    ap.add_argument(
        "--RefineCTFAmp",
        action="store_true",
        help="(Optional) With --Refine: also refine the CTF amplitude "
        "(clamped to (0,1) against the Gaussian amp prior)",
    )
    ap.add_argument("--help", action="help", help="(Optional) Produce help message")
    return ap


def write_refined(f, out) -> None:
    """Output_Refined writer (framework extension — the reference cannot
    differentiate its pipeline; see bioem_tpu/refine.py)."""
    f.write(
        "************************* HEADER: REFINED PARAMETERS "
        "*******************************\n"
    )
    f.write(
        "Refined Parameters: quaternions q1 q2 q3 q4, center displacement "
        "x y, CTF phase & envelope & amplitude\n"
    )
    f.write(
        "Columns: RefMap LogProSeed LogProRefined q1 q2 q3 q4 CentX CentY "
        "Pha Env Amp GradNorm\n"
    )
    f.write(
        "*********************************************************"
        "****************************\n"
    )
    for i in range(out.rotmat.shape[0]):
        q = out.quaternion[i]
        f.write(
            f"RefMap: {i} LogPro: {out.logpro_seed[i]:12.6f} -> "
            f"{out.logpro_refined[i]:12.6f} Quat: {q[0]:12.6f} {q[1]:12.6f} "
            f"{q[2]:12.6f} {q[3]:12.6f} Cent: {out.cent_x[i]:10.4f} "
            f"{out.cent_y[i]:10.4f} Pha: {out.pha[i]:12.6f} Env: "
            f"{out.env[i]:12.6f} Amp: {out.amp[i]:8.4f} "
            f"GradNorm: {out.grad_norm[i]:.3e}\n"
        )


def write_rotated_models(model, orients, out) -> None:
    """PRINT_ROTATED_MODELS debug output (reference bioem.cpp:1695-1702):
    'ROTATED iOrient iPoint x y z' per rotated model point."""
    import jax.numpy as jnp

    from .core.orientations import rotation_matrices

    rotms = np.asarray(
        rotation_matrices(jnp.asarray(orients.angles), orients.use_quaternions)
    )
    for imap in range(orients.n):
        rot = np.matmul(model.points, rotms[imap].T)
        for k in range(model.n_points):
            out.write(
                f"ROTATED {imap} {k} {rot[k, 0]:g} {rot[k, 1]:g} {rot[k, 2]:g}\n"
            )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = RunConfig.from_env()

    from .config import use_compile_cache

    use_compile_cache()

    # Multi-host bootstrap (reference main.cpp:64-68 runs MPI_Init
    # unconditionally; initialize() is a safe no-op single-host). Must come
    # before anything touches the XLA backend. The (img × orient) mesh comes
    # from BIOEM_TPU_MESH_IMAGES/_ORIENT via RunConfig.
    from .parallel.distributed import initialize

    initialize()

    if args.ReadMultipleMRC and not args.ReadMRC:
        print("Error - For multiple MRCs command --ReadMRC is necessary too")
        return 1

    # ---- PrintBestCalMap mode (reference main.cpp:97-108) ----
    if args.PrintBestCalMap:
        from .simulator import write_best_map

        bp = read_best_params(args.PrintBestCalMap)
        model = read_model(
            args.Modelfile,
            read_pdb=args.ReadPDB,
            read_mrc=args.ReadModelMRC,
            load_dump=args.LoadModelDump,
            dump=args.DumpModel,
            pixel_size=bp.pixel_size,
            center_mass=not bp.no_center_mass,
        )
        if args.PrintCOORDREAD:
            write_coordread(model)
        with open(defs.FILE_BESTMAP, "w") as f:
            write_best_map(bp, model, f)
        print(
            "\n\nBest map printed in file: BESTMAP with gnuplot format in "
            "columns 2, 3 and 4. \n\n"
        )
        return 0

    for req in ("Modelfile", "Particlesfile", "Inputfile"):
        if getattr(args, req) is None:
            print("Error - Need to specify all mandatory options")
            build_parser().print_help()
            return 1

    t0 = time.perf_counter()
    p = read_parameters(args.Inputfile, not_uniform_angles=args.ReadOrientation is not None)

    images = read_ref_maps(
        args.Particlesfile,
        p.n_pixels,
        read_mrc=args.ReadMRC,
        read_mult_mrc=args.ReadMultipleMRC,
        load_dump=args.LoadMapDump,
        dump=args.DumpMaps,
        normalize=not p.no_map_norm,
        debug_nmaps=cfg.debug_nmaps,
    )
    print(f"Total Number of particles: {images.n}")

    model = read_model(
        args.Modelfile,
        read_pdb=args.ReadPDB,
        read_mrc=args.ReadModelMRC,
        load_dump=args.LoadModelDump,
        dump=args.DumpModel,
        pixel_size=p.pixel_size,
        ignore_pdb=p.ignore_pdb,
        center_mass=not p.no_center_mass,
    )
    print(f"Total Number of Voxels {model.n_points}")
    print(f"Total Number of Electrons {model.norm_den:g}")
    if args.PrintCOORDREAD:
        write_coordread(model)

    from .core.orientations import build_orientations

    orients = build_orientations(p, args.ReadOrientation)
    if p.print_rotated_models:
        write_rotated_models(model, orients, sys.stdout)
    if cfg.debug_output >= 1:
        print(f"Setup time: {time.perf_counter() - t0:.2f}s")

    # ---- engine run (multi-device aware) ----
    from .run import run_bioem

    t0 = time.perf_counter()
    results, perf = run_bioem(p, orients, model, images, cfg)
    if cfg.debug_output >= 1:
        print(
            f"Main loop: {perf['run_s']:.3f}s "
            f"({perf['comparisons_per_s']:.3e} comparisons/s)"
        )

    # Output on process 0 only (reference: MPI rank 0 writes,
    # bioem.cpp:1046) — results() has already allgathered across hosts.
    import jax

    if jax.process_index() == 0:
        with open(args.OutputFile, "w") as f:
            write_probabilities(f, p, orients, results.grid, results)
        if p.write_angles:
            with open(defs.FILE_ANG_PROB, "w") as f:
                write_angle_probabilities(f, p, orients, results)
        # Per-evaluation debug dump (reference DEBUG_PROB, defs.h:52):
        # BIOEM_TPU_DEBUG_PROB=<image index> writes every (orientation,
        # ctf, displacement) logpro of that image for cross-path diffing.
        # Multi-host guard (advisor r4): dump_logpro launches fresh jitted
        # computations over the engine's banks — with globally sharded
        # banks a rank-0-only launch deadlocks the collective, the same
        # hazard class as the --Refine guard below.
        if jax.process_count() > 1:
            import os as _os

            if _os.environ.get("BIOEM_TPU_DEBUG_PROB") is not None:
                print(
                    "WARNING: BIOEM_TPU_DEBUG_PROB is not supported in "
                    "multi-host runs; skipping the per-evaluation dump. "
                    "Re-run single-host with the same inputs to produce it."
                )
        else:
            from .debug_prob import maybe_dump_from_env

            maybe_dump_from_env(perf["engine"])

    # ---- optional continuous refinement (no reference analogue) ----
    if args.Refine and jax.process_count() > 1:
        # refine_results is single-process (it gathers sharded banks to the
        # host and would raise NotImplementedError after the main compute
        # finished). Skip loudly rather than crash the multi-host run.
        print(
            "WARNING: --Refine is not supported in multi-host runs; "
            "skipping refinement. Re-run single-host with --LoadMapDump "
            "or call bioem_tpu.refine.refine_results per host with "
            "image_indices=engine.owned_image_rows()."
        )
    elif args.Refine:
        from .refine import refine_results

        t0 = time.perf_counter()
        refined = refine_results(
            perf["engine"], results, refine_ctf=args.RefineCTF,
            refine_ctf_amp=args.RefineCTFAmp,
        )
        if cfg.debug_output >= 1:
            print(f"Refinement: {time.perf_counter() - t0:.2f}s")
        if jax.process_index() == 0:
            with open(defs.FILE_REFINED, "w") as f:
                write_refined(f, refined)
            print(f"Refined parameters written to: {defs.FILE_REFINED}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
