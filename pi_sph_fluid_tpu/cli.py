"""Command-line entry points.

Replaces the reference's two Make targets (`Makefile:18-27`): ``run`` is the
interactive simulator (the `desktop_sph_fluid` / `pi_sph_fluid` equivalent,
with --realtime and sensor/display selection as runtime flags instead of
compile-time -D defines), ``bench`` free-runs without pacing (the
commented-out-REALTIME benchmarking mode, `pi_sph_fluid.c:10`).

    python -m pi_sph_fluid_tpu.cli run --scene drop --seconds 3 --display terminal
    python -m pi_sph_fluid_tpu.cli bench --n 1000000 --steps 200
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from .config import SPHConfig
from .models.scene import build_dam_break_scene, build_drop_scene, build_pool_scene


def _make_scene(args):
    cfg = SPHConfig(r=args.r, dt_factor=getattr(args, "dt_factor", 1.0))
    builders = {"drop": build_drop_scene, "dam": build_dam_break_scene,
                "pool": build_pool_scene}
    if args.scene not in builders:
        raise SystemExit(f"unknown scene {args.scene!r}")
    fluid, braw = builders[args.scene](cfg)
    return cfg, fluid, braw


def _make_gravity(args, cfg, sink=None):
    from .io.gravity import (
        ConstantGravity, MPU6050Gravity, RotatingGravity, TraceGravity,
        WebGravity,
    )

    if args.gravity == "constant":
        return ConstantGravity(cfg)
    if args.gravity == "rotate":
        return RotatingGravity(cfg, period_s=args.rotate_period)
    if args.gravity == "mpu6050":
        return MPU6050Gravity(cfg)
    if args.gravity == "web":
        from .io.web import WebSink

        inner = getattr(sink, "inner", None)   # sinks are AsyncSink-wrapped
        if not isinstance(inner, WebSink):
            raise SystemExit("--gravity web needs --display web "
                             "(the page is the tilt sensor)")
        return WebGravity(cfg, inner)
    if args.gravity.startswith("trace:"):
        import numpy as np

        data = np.load(args.gravity[6:])
        samples = data["samples"] if hasattr(data, "files") else data
        return TraceGravity(samples, sample_hz=float(getattr(args, "trace_hz", 10.0)))
    raise SystemExit(f"unknown gravity source {args.gravity!r}")


def _parse_render_shape(s: str) -> tuple[int, int]:
    try:
        rows, cols = (int(v) for v in s.lower().split("x"))
    except ValueError:
        raise SystemExit(f"bad --render-shape {s!r} (want ROWSxCOLS, e.g. 64x128)")
    if rows % 8:
        raise SystemExit("--render-shape rows must be a multiple of 8 "
                         "(page-packed 1-bpp framebuffer)")
    return rows, cols


def _make_sink(args, shape: tuple[int, int]):
    from .io.display import (AsyncSink, FileSink, GifSink, NullSink, PngSink,
                             TerminalSink)

    rows, cols = shape
    if args.display == "none":
        return NullSink()
    if args.display == "terminal":
        return AsyncSink(TerminalSink(rows, cols))
    if args.display.startswith("file:"):
        return AsyncSink(FileSink(args.display[5:]))
    if args.display.startswith("png:"):
        return AsyncSink(PngSink(args.display[4:], rows, cols))
    if args.display.startswith("gif:"):
        # no AsyncSink: push is an O(1 KB) append, the encode runs at close
        return GifSink(args.display[4:], rows, cols)
    if args.display.startswith("web"):
        from .io.web import WebSink

        port = int(args.display.split(":")[1]) if ":" in args.display else 8742
        return AsyncSink(WebSink(port, rows, cols))
    if args.display.startswith("ssd1306"):
        from .io.ssd1306 import SSD1306Sink

        bus = int(args.display.split(":")[1]) if ":" in args.display else 1
        return AsyncSink(SSD1306Sink(bus=bus))
    raise SystemExit(f"unknown display {args.display!r}")


def _maybe_init_distributed(args):
    """Multi-host launch: join the cross-process JAX runtime before
    the first backend touch (SURVEY §5 distributed row; the cluster recipe is
    in parallel/launch.py).  On processes > 0 the display and report
    stream are silenced — every host runs the same sim, host 0 owns I/O."""
    if getattr(args, "num_processes", 1) and args.num_processes > 1:
        if args.coordinator is None:
            raise SystemExit("--num-processes > 1 needs --coordinator "
                             "HOST:PORT (process 0's address)")
        if args.process_id is None:
            raise SystemExit("--num-processes > 1 needs --process-id")
        from .parallel.launch import init_distributed

        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)
        if args.process_id > 0:
            if getattr(args, "display", None) not in (None, "none"):
                print(f"process {args.process_id}: display -> none "
                      f"(host 0 owns I/O)", file=sys.stderr)
                args.display = "none"
            return False   # not the I/O owner
    return True


def _engine_opts(args) -> dict:
    opts = dict(cap=args.cap)
    if args.interpret:
        opts["interpret"] = True
    if args.backend == "pallas-dd" and args.slabs:
        opts["slabs"] = args.slabs
    return opts


def cmd_run(args):
    from .io.host_loop import SimRunner

    io_owner = _maybe_init_distributed(args)
    cfg, fluid, braw = _make_scene(args)
    loaded = None
    if args.load_state:
        from .state import load_state

        loaded = load_state(args.load_state)
        fluid = loaded["fluid"]
        print(f"resumed {fluid.n} particles from {args.load_state}", file=sys.stderr)
    print(f"dt = {cfg.dt:.6f}    (expected ticks/s) {int(1 / cfg.dt)}")
    print(f"n_fluid = {fluid.n}")
    print(f"n_boundary = {braw.n}")
    render_shape = _parse_render_shape(args.render_shape)
    engine_opts = _engine_opts(args)
    runner = SimRunner(cfg, fluid, braw, backend=args.backend,
                       engine_opts=engine_opts,
                       render=args.display != "none",
                       render_shape=render_shape,
                       resort_every=args.resort_every,
                       auto_cap=not args.no_auto_cap,
                       max_cap=args.max_cap,
                       max_resort=args.max_resort or None)
    sink = _make_sink(args, render_shape)
    gravity = _make_gravity(args, cfg, sink)
    # Lossless pallas resume: a re-prime from the id-ordered fluid view
    # recomputes au/av exactly (they are pure functions of the state) BUT
    # rebuilds the layout with id-order tie-breaking, while a continuous
    # run's stable sort ties by the PREVIOUS layout order — intra-cell
    # summation order shifts, so reprime-resume is only ulp-close, not
    # bitwise.  The npz therefore carries the raw layout arrays (packed,
    # au, av — the dd backend's export/init standard, domain_window) and
    # resume reconstructs the PackedSim verbatim when shapes still match
    # (n_layout is cap-independent, so capacity recoveries don't break it).
    resume = None
    if loaded is not None and runner.engine is not None and "packed" in loaded:
        pk = loaded["packed"]
        if pk.shape[0] == runner.engine.n_layout:
            from .models.engine_v3 import PackedSim

            resume = PackedSim(packed=pk, ids=loaded["ids"],
                               au=loaded["au"], av=loaded["av"])
        else:
            print(f"layout size changed ({pk.shape[0]} -> "
                  f"{runner.engine.n_layout}): re-priming from the fluid "
                  f"view (ulp-level resume)", file=sys.stderr)
    try:
        result = runner.run(
            gravity, sink, sim_seconds=args.seconds, realtime=args.realtime,
            steps_per_dispatch=args.steps_per_dispatch,
            report_stream=sys.stderr if io_owner else None,
            settle_seconds=args.settle_seconds,
            resume=resume,
        )
    finally:
        sink.close()
    if args.save_state:
        from .state import save_state

        sim = result.sim
        if runner.engine is not None:
            # pallas: the portable id-ordered view PLUS the raw layout
            # arrays for bitwise resume (leapfrog carry included —
            # the dd export/init sets the standard)
            fl = runner.engine.unpad(sim)
            save_state(args.save_state, fluid=fl, packed=sim.packed,
                       ids=sim.ids, au=sim.au, av=sim.av)
        elif getattr(runner, "domain", None) is not None:  # pallas-dd
            save_state(args.save_state, fluid=runner.domain.gather(sim))
        else:
            save_state(args.save_state, fluid=sim.fluid, ids=sim.ids,
                       au=sim.au, av=sim.av)
        print(f"state saved to {args.save_state}", file=sys.stderr)
    extra = (f", {result.recoveries} capacity recover"
             f"{'y' if result.recoveries == 1 else 'ies'}"
             if result.recoveries else "")
    by = result.reporter.total_overflow_by
    if by is not None and int(by.sum()) > 0:   # dd attribution, if any
        from .models.simulation import OVERFLOW_CATEGORIES

        named = {n: int(c) for n, c in
                 zip(OVERFLOW_CATEGORIES, by) if c > 0}
        extra += f", unrecovered overflow by capacity: {named}"
    print(f"\n{result.steps} steps in {result.wall_s:.2f}s "
          f"({result.particle_steps_per_s / 1e6:.2f}M particle-steps/s)"
          f"{extra}", file=sys.stderr)
    return result


def cmd_bench(args):
    from .io.gravity import ConstantGravity
    from .io.host_loop import SimRunner

    io_owner = _maybe_init_distributed(args)

    # size the pool scene to ~n particles (fill area ~6.35 m^2 at the
    # default 4x2 domain; the pool is the layout's design point)
    r = math.sqrt(6.35 / args.n)
    cfg = SPHConfig(r=r)
    fluid, braw = build_pool_scene(cfg)
    # auto_cap off: a bench measures the configured cap — silent mid-run
    # escalation (a recompile) would distort the number; overflow shows in
    # the JSON instead
    runner = SimRunner(cfg, fluid, braw, backend=args.backend,
                       engine_opts=_engine_opts(args),
                       render=args.render, resort_every=args.resort_every,
                       auto_cap=False)
    gravity = ConstantGravity(cfg)
    # warmup dispatch compiles everything; must use the same scan length as
    # the measured run or the measured run recompiles
    runner.run(gravity, None, sim_seconds=args.steps * cfg.dt,
               steps_per_dispatch=args.steps)
    result = runner.run(gravity, None, sim_seconds=args.steps * cfg.dt,
                        steps_per_dispatch=args.steps)
    out = {
        "metric": "particle_steps_per_s",
        "value": result.particle_steps_per_s,
        "unit": "particle-steps/s",
        "n_fluid": result.n_fluid,
        "steps": result.steps,
        "wall_s": result.wall_s,
        "backend": args.backend,
        "resort_every": args.resort_every,
        "max_rho_error_pct_worst": result.reporter.worst_rho_error_pct,
        "neighbor_overflow": result.reporter.total_overflow,
        "stale_drift": result.reporter.total_stale,
    }
    if io_owner:
        print(json.dumps(out))
    return out


def _add_interpret_arg(p):
    p.add_argument("--interpret", action="store_true",
                   help="run the Pallas kernels in interpret mode (CPU dry "
                        "runs and tests; slow)")


def _add_distributed_args(p):
    """Multi-host launch flags — see parallel/launch.py for the cluster
    recipe.  Single-host runs leave them at their defaults."""
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's coordinator address (multi-host runs)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total hosts in the run (jax.distributed)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's index, 0..num-processes-1")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pi_sph_fluid_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="interactive simulation")
    _add_distributed_args(rp)
    rp.add_argument("--scene", default="drop", choices=["drop", "dam", "pool"])
    rp.add_argument("--r", type=float, default=0.075, help="particle spacing (m)")
    rp.add_argument("--dt-factor", type=float, default=1.0,
                    help="DT = dt_factor * H / C.  The reference runs 1.0 "
                         "but its own CFL note says 0.4 (`pi_sph_fluid.c:19`)"
                         " — use 0.4 for long-horizon fine-resolution scenes")
    rp.add_argument("--seconds", type=float, default=2.0, help="sim seconds")
    rp.add_argument("--backend", default="pallas",
                    choices=["pallas", "pallas-dd", "reference"])
    rp.add_argument("--slabs", type=int, default=None,
                    help="pallas-dd: number of device slabs "
                         "(default: all visible devices)")
    rp.add_argument("--display", default="terminal",
                    help="terminal | none | file:<path> | png:<prefix> "
                         "| gif:<path> (record the run as one looping GIF) "
                         "| web[:port] (live browser view, the SDL-window "
                         "analog) | ssd1306[:bus]")
    rp.add_argument("--gravity", default="constant",
                    help="constant | rotate | mpu6050 | web (browser tilt "
                         "via the web display's page — drag to slosh) | "
                         "trace:<file.np[z]> (a recorded (T,2) accelerometer "
                         "session)")
    rp.add_argument("--trace-hz", type=float, default=10.0,
                    help="sample rate of a replayed gravity trace")
    rp.add_argument("--rotate-period", type=float, default=4.0)
    rp.add_argument("--render-shape", default="64x128", metavar="ROWSxCOLS",
                    help="framebuffer geometry (rows must be a multiple of "
                         "8); the sink unpacks with the same shape")
    rp.add_argument("--realtime", action="store_true",
                    help="pace to wall-clock like the reference REALTIME mode")
    rp.add_argument("--steps-per-dispatch", type=int, default=None,
                    help="steps per device dispatch (default: one display "
                         "frame's worth, or a report interval headless); "
                         "raise on high-latency device attachments")
    rp.add_argument("--settle-seconds", type=float, default=0.0,
                    help="damped pre-roll to bleed off the startup transient "
                         "(recommended >= 0.3 for fine resolutions)")
    rp.add_argument("--cap", type=int, default=384,
                    help="candidate-window lane capacity; 256 is enough for "
                         "settled flows, 384 covers strong free-surface "
                         "transients (overflow is counted, never silent)")
    rp.add_argument("--max-cap", type=int, default=1024,
                    help="elastic-capacity ceiling: on window overflow the "
                         "runner grows cap 1.5x (recompiling) and replays the "
                         "dirty interval from the last clean report, up to "
                         "this cap (pallas backend)")
    rp.add_argument("--no-auto-cap", action="store_true",
                    help="disable elastic capacity recovery; overflow is "
                         "still counted and reported")
    rp.add_argument("--resort-every", type=int, default=8,
                    help="sticky-layout interval: re-sort the grid every k "
                         "steps.  Guarded at runtime: every carried tick "
                         "counts particles drifting past the 0.3*H fringe "
                         "margin (the k<=4-at-C/10 certified envelope) and "
                         "the runner halves k and replays on a trip — so "
                         "the default 8 is exact-or-downgraded, never "
                         "silently lossy.  1 = exact per-step relayout")
    rp.add_argument("--max-resort", type=int, default=64,
                    help="upward resort ladder ceiling: after 2 clean "
                         "report intervals the runner doubles resort_every "
                         "up to this value (the guard certifies any period "
                         "while stale reads 0; a trip halves it and pins "
                         "the ceiling below the tripped period).  0 = off; "
                         "ignored under --realtime (raising recompiles)")
    rp.add_argument("--save-state", default=None, metavar="F.npz",
                    help="checkpoint the final fluid state")
    rp.add_argument("--load-state", default=None, metavar="F.npz",
                    help="start from a checkpointed fluid state instead of "
                         "the scene's initial layout")
    _add_interpret_arg(rp)
    rp.set_defaults(fn=cmd_run)

    bp = sub.add_parser("bench", help="headless throughput benchmark")
    _add_distributed_args(bp)
    bp.add_argument("--n", type=int, default=1_000_000, help="target particle count")
    bp.add_argument("--steps", type=int, default=200)
    bp.add_argument("--backend", default="pallas",
                    choices=["pallas", "pallas-dd", "reference"])
    bp.add_argument("--slabs", type=int, default=None,
                    help="pallas-dd: number of device slabs "
                         "(default: all visible devices)")
    bp.add_argument("--render", action="store_true", help="include rendering in the loop")
    bp.add_argument("--cap", type=int, default=256)
    bp.add_argument("--resort-every", type=int, default=8)
    _add_interpret_arg(bp)
    bp.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if argv is None:
        # the command line (python -m / the console script): keep compiled
        # executables across runs.  In-process callers pass argv and keep
        # their own cache settings.
        from .utils.compile_cache import configure_compile_cache

        configure_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    main()
