"""Device-time breakdown of the engine's block step, from a jax.profiler trace.

Runs the bench problem's jitted orientation-block scan over a few blocks
under the profiler and reads the GPU planes of the trace:

* device time per layer — the named scopes of ``BioEMEngine._block_step``
  (project, convolve, constants, cc_product, cc_stage1, cc_stage2, lse,
  merge), found through the op_name metadata of the compiled HLO;
* the top device operations;
* the device's busy share of the traced window (union of kernel intervals
  over first-kernel-start .. last-kernel-end).

Needs a GPU. By default XLA's command buffers (CUDA graphs) are off for
the traced process, so that every kernel, cuBLAS calls included, reports
its HLO instruction; ``--keep-graphs`` traces the production setting, where
kernels inside a graph are matched to HLO by name only. Writes
``trace_step.json`` and the raw ``.xplane.pb`` to ``--out`` (re-reduce a
saved trace with ``--xplane FILE --hlo FILE``).

Usage: python tools/trace_step.py [--blocks 8] [--out DIR]
"""

import argparse
import collections
import glob
import json
import os
import re
import shutil
import sys
import tempfile
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Most specific first: an op's layer is the first scope in its op_name path.
LAYERS = ("cc_product", "cc_stage1", "cc_stage2", "lse", "constants",
          "merge", "convolve", "project")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")


def hlo_op_names(hlo_text: str) -> dict:
    """{HLO instruction name: op_name metadata} of a compiled module, also
    under the kernel spelling of the name ('.' → '_', as XLA names the GPU
    kernel it emits for a fusion)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = m.group(2)
            out.setdefault(m.group(1).replace(".", "_"), m.group(2))
    return out


def layer_of(op_name: str) -> str:
    parts = op_name.split("/")
    for layer in LAYERS:
        if layer in parts:
            return layer
    return "other"


def reduce_trace(data, op_names: dict) -> dict:
    """Per-layer and per-op device time of the first GPU plane of a
    ``jax.profiler.ProfileData`` trace."""
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise ValueError(f"no GPU plane in trace: {[p.name for p in data.planes]}")
    ops = collections.defaultdict(lambda: [0, 0, ""])  # ns, count, layer
    layers = collections.Counter()
    intervals = []
    line_names = set()
    for plane in planes[:1]:  # the traced program runs on device 0
        for line in plane.lines:
            events = list(line.events)
            if not events:
                continue
            line_names.add(line.name)
            for e in events:
                with warnings.catch_warnings():  # pybind stats type
                    warnings.simplefilter("ignore", DeprecationWarning)
                    stats = dict(e.stats)
                hlo = str(stats.get("hlo_op", ""))
                if not hlo or hlo == "command_buffer":
                    hlo = e.name  # kernel inside a CUDA graph
                op_name = op_names.get(hlo) or op_names.get(e.name, "")
                layer = layer_of(op_name) if op_name else "other"
                rec = ops[hlo]
                rec[0] += e.duration_ns
                rec[1] += 1
                rec[2] = layer
                layers[layer] += e.duration_ns
                intervals.append((e.start_ns, e.end_ns))
    intervals.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0
    kernel_ns = sum(layers.values())
    return {
        "plane": planes[0].name,
        "lines": sorted(line_names),
        "kernel_ns": kernel_ns,
        "busy_ns": busy,
        "window_ns": window,
        "idle_share": 1.0 - busy / window if window else None,
        "layers_ns": dict(layers.most_common()),
        "ops": sorted(
            ({"op": k, "ns": v[0], "count": v[1], "layer": v[2]}
             for k, v in ops.items()),
            key=lambda r: -r["ns"],
        ),
    }


def print_report(rep: dict, n_cmp: int, n_blocks: int) -> None:
    kernel = rep["kernel_ns"]
    print(f"device plane {rep['plane']}, lines {rep['lines']}")
    print(f"kernel time {kernel / 1e6:.4f} ms; window "
          f"{rep['window_ns'] / 1e6:.4f} ms; busy {rep['busy_ns'] / 1e6:.4f} ms; "
          f"idle share {rep['idle_share']:.4f}")
    if kernel and n_cmp:
        print(f"{n_blocks} blocks, {n_cmp} comparisons -> "
              f"{n_cmp / (kernel / 1e9):.6g} comparisons/s of kernel time")
    print(f"{'layer':<12} {'ms':>10} {'%':>6}")
    for layer, ns in rep["layers_ns"].items():
        print(f"{layer:<12} {ns / 1e6:10.4f} {100 * ns / kernel:6.2f}")
    print(f"{'op':<56} {'layer':<11} {'ms':>9} {'count':>6} {'%':>6}")
    for r in rep["ops"][:25]:
        print(f"{r['op'][:56]:<56} {r['layer']:<11} {r['ns'] / 1e6:9.4f} "
              f"{r['count']:6d} {100 * r['ns'] / kernel:6.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=8,
                    help="orientation blocks in the traced scan")
    ap.add_argument("--out", default="",
                    help="directory for trace_step.json and the raw trace")
    ap.add_argument("--xplane", help="reduce this saved trace instead of running")
    ap.add_argument("--hlo", help="compiled HLO text saved with --xplane's trace")
    ap.add_argument("--keep-graphs", action="store_true",
                    help="keep XLA's command buffers (CUDA graphs) on")
    args = ap.parse_args(argv)

    if args.xplane:
        from jax.profiler import ProfileData

        with open(args.hlo) as f:
            rep = reduce_trace(ProfileData.from_file(args.xplane),
                               hlo_op_names(f.read()))
        print_report(rep, 0, 0)
        return

    if not args.keep_graphs:  # must precede the backend's start
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
        ).strip()
    import jax

    from bench import build_problem
    from bioem_tpu.config import RunConfig, use_compile_cache
    from bioem_tpu.run import make_engine

    use_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {jax.devices()[0].platform!r}")
    p, orients, model, images = build_problem()
    eng = make_engine(p, orients, model, images, RunConfig.from_env())
    nb = args.blocks
    print(f"block: O={eng.o_block} C={eng.n_ctf} I={eng.n_img_pad} "
          f"(image_block {eng.i_block}) N={p.n_pixels} D={len(eng.disp)}; "
          f"{nb} blocks; device {jax.devices()[0].device_kind}")

    def make_args():  # fresh state per call: the scan donates it
        return (eng.initial_state(), eng.banks, eng.ang_blocks[:nb],
                eng.offsets[:nb], eng.mask_blocks[:nb])

    hlo = eng._scan_run.lower(*make_args()).compile().as_text()
    jax.block_until_ready(eng._scan_run(*make_args()).total)  # compile, warm
    call_args = make_args()
    tracedir = tempfile.mkdtemp(prefix="trace_step_")
    try:
        with jax.profiler.trace(tracedir):
            jax.block_until_ready(eng._scan_run(*call_args).total)
        (xplane,) = glob.glob(f"{tracedir}/plugins/profile/*/*.xplane.pb")
        rep = reduce_trace(jax.profiler.ProfileData.from_file(xplane),
                           hlo_op_names(hlo))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            shutil.copy(xplane, os.path.join(args.out, "step.xplane.pb"))
            with open(os.path.join(args.out, "step.hlo.txt"), "w") as f:
                f.write(hlo)
    finally:
        shutil.rmtree(tracedir, ignore_errors=True)
    n_cmp = nb * eng.o_block * eng.n_ctf * eng.n_img
    rep.update(n_blocks=nb, comparisons=n_cmp, graphs=args.keep_graphs,
               device_kind=jax.devices()[0].device_kind)
    print_report(rep, n_cmp, nb)
    if args.out:
        with open(os.path.join(args.out, "trace_step.json"), "w") as f:
            json.dump(rep, f, indent=1)


if __name__ == "__main__":
    main()
