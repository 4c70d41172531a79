"""Host I/O shell tests: gravity sources, sinks, generic SPH operators,
profiling helpers, CLI checkpoint round trip."""

import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pi_sph_fluid_tpu.config import SPHConfig
from pi_sph_fluid_tpu.io.display import AsyncSink, FileSink, NullSink, TerminalSink
from pi_sph_fluid_tpu.io.gravity import ConstantGravity, RotatingGravity, TraceGravity
from pi_sph_fluid_tpu.models.boundary import prepare_boundary
from pi_sph_fluid_tpu.models.scene import build_drop_scene
from pi_sph_fluid_tpu.render.metaballs import pack_framebuffer

CFG = SPHConfig()


def test_constant_gravity_trace():
    g = ConstantGravity(CFG)
    tr = g.trace(16, CFG.dt)
    assert tr.shape == (16, 2)
    np.testing.assert_allclose(tr, [[0.0, -9.81]] * 16)


def test_trace_gravity_replays_samples():
    """A recorded 10 Hz accelerometer session replays as per-step vectors
    (BASELINE.json config 3): every step between polls sees the same vector,
    like the reference's unsynchronized shared float2."""
    samples = np.asarray([[0.0, -9.81], [1.0, -9.0], [2.0, -8.0]], np.float32)
    g = TraceGravity(samples, sample_hz=10.0, loop=False)
    # 0.25 s at dt: spans samples 0,1,2
    n = int(0.25 / CFG.dt)
    tr = g.trace(n, CFG.dt)
    assert tr.shape == (n, 2)
    # first step sees sample 0; step at t=0.11 sees sample 1; t=0.21 sample 2
    np.testing.assert_allclose(tr[0], samples[0])
    np.testing.assert_allclose(tr[int(0.11 / CFG.dt)], samples[1])
    np.testing.assert_allclose(tr[int(0.21 / CFG.dt)], samples[2])
    # trace continues where it left off
    tr2 = g.trace(4, CFG.dt)
    np.testing.assert_allclose(tr2[0], samples[2])  # past the end, clamped


def test_rotating_gravity_magnitude():
    g = RotatingGravity(CFG, period_s=1.0)
    tr = g.trace(100, 0.01)
    mags = np.hypot(tr[:, 0], tr[:, 1])
    np.testing.assert_allclose(mags, CFG.g, rtol=1e-5)


def test_terminal_sink_renders_halfblocks():
    lit = np.zeros((64, 128), bool)
    lit[:2, :4] = True
    buf = np.asarray(pack_framebuffer(jnp.asarray(lit), 64, 128))
    out = io.StringIO()
    sink = TerminalSink(stream=out)
    sink.push(buf)
    text = out.getvalue()
    assert "█" in text.splitlines()[0][:4]


def test_async_sink_drops_rather_than_blocks():
    class Slow:
        def __init__(self):
            self.got = 0

        def push(self, fb):
            time.sleep(0.05)
            self.got += 1

        def close(self):
            pass

    inner = Slow()
    sink = AsyncSink(inner)
    fb = np.zeros(1024, np.uint8)
    t0 = time.perf_counter()
    for _ in range(50):
        sink.push(fb)  # must never block the producer
    produced_fast = time.perf_counter() - t0 < 0.5
    sink.close()
    assert produced_fast
    assert 0 < inner.got < 50  # some frames dropped by design


def _gif_lzw_decode(data: bytes, mcs: int) -> list[int]:
    """Independent GIF-LZW decoder (test-side oracle for GifSink)."""
    clear = 1 << mcs
    eoi = clear + 1
    base = {i: (i,) for i in range(clear)}
    table = dict(base)
    width = mcs + 1
    next_code = eoi + 1
    out: list[int] = []
    prev = None
    acc = 0
    nbits = 0
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= width:
            code = acc & ((1 << width) - 1)
            acc >>= width
            nbits -= width
            if code == clear:
                table = dict(base)
                width = mcs + 1
                next_code = eoi + 1
                prev = None
                continue
            if code == eoi:
                return out
            if prev is None:
                entry = table[code]
            elif code in table:
                entry = table[code]
                table[next_code] = prev + (entry[0],)
                next_code += 1
            else:  # the KwKwK case
                entry = prev + (prev[0],)
                table[next_code] = entry
                next_code += 1
            out.extend(entry)
            if next_code == (1 << width) and width < 12:
                width += 1
            prev = entry
    raise AssertionError("no EOI code in LZW stream")


def _parse_gif(blob: bytes):
    """Minimal GIF89a parser: returns (w, h, delays, frames) with frames
    decoded to flat pixel-index lists."""
    assert blob[:6] == b"GIF89a"
    w, h = int.from_bytes(blob[6:8], "little"), int.from_bytes(blob[8:10], "little")
    packed = blob[10]
    assert packed & 0x80  # global color table present
    gct_len = 2 ** ((packed & 7) + 1)
    pos = 13 + 3 * gct_len
    delays, frames = [], []
    delay = 0
    while True:
        b = blob[pos]
        if b == 0x3B:  # trailer
            break
        if b == 0x21:  # extension: label + sub-blocks
            label = blob[pos + 1]
            pos += 2
            if label == 0xF9:
                delay = int.from_bytes(blob[pos + 2:pos + 4], "little")
            while blob[pos]:  # skip sub-blocks
                pos += 1 + blob[pos]
            pos += 1
        elif b == 0x2C:  # image descriptor
            iw = int.from_bytes(blob[pos + 5:pos + 7], "little")
            ih = int.from_bytes(blob[pos + 7:pos + 9], "little")
            assert (iw, ih) == (w, h) and blob[pos + 9] == 0
            pos += 10
            mcs = blob[pos]
            pos += 1
            data = bytearray()
            while blob[pos]:
                n = blob[pos]
                data += blob[pos + 1:pos + 1 + n]
                pos += 1 + n
            pos += 1
            px = _gif_lzw_decode(bytes(data), mcs)
            assert len(px) == w * h
            delays.append(delay)
            frames.append(px)
        else:
            raise AssertionError(f"unexpected GIF block 0x{b:02x}")
    return w, h, delays, frames


def test_gif_sink_roundtrip(tmp_path):
    """GifSink's stream must decode (via an independent LZW decoder) to
    exactly the pushed frames, top row first like every other sink."""
    from pi_sph_fluid_tpu.io.display import GifSink
    from pi_sph_fluid_tpu.render.metaballs import unpack_framebuffer

    rng = np.random.default_rng(7)
    path = tmp_path / "demo.gif"
    sink = GifSink(str(path), rows=64, cols=128, scale=2, fps=25)
    pushed = []
    for k in range(3):
        fb = rng.integers(0, 256, size=8 * 128, dtype=np.uint8)
        if k == 0:  # top-left pixel lit: orientation canary
            fb = fb.copy()
            fb[0] |= 1
        pushed.append(fb)
        sink.push(fb)
    sink.close()

    w, h, delays, frames = _parse_gif(path.read_bytes())
    assert (w, h) == (256, 128)
    assert delays == [4, 4, 4]  # 100/25
    assert len(frames) == 3
    for fb, px in zip(pushed, frames):
        lit = unpack_framebuffer(fb, 64, 128)
        want = np.repeat(np.repeat(lit.astype(np.uint8), 2, 0), 2, 1)
        np.testing.assert_array_equal(np.asarray(px).reshape(h, w), want)
    # the canary: framebuffer row 0 must be the TOP row of the image
    assert frames[0][0] == 1


def test_gif_sink_decimates_long_runs(tmp_path):
    """Runs longer than max_frames thin 2x and double the delay, so any
    run length yields a bounded, uniformly-sampled loop."""
    from pi_sph_fluid_tpu.io.display import GifSink

    path = tmp_path / "long.gif"
    sink = GifSink(str(path), rows=8, cols=8, scale=1, fps=50, max_frames=4)
    for k in range(11):
        sink.push(np.full(8, k, np.uint8))
    # 0..3 recorded -> thinned to [0, 2] (stride 2); 4, 6 recorded -> the
    # full [0, 2, 4, 6] thins to [0, 4] (stride 4); 8 recorded, 9-10 skipped
    assert [f[0] for f in sink.frames] == [0, 4, 8]
    sink.close()
    _, _, delays, frames = _parse_gif(path.read_bytes())
    assert len(frames) == 3
    assert delays == [8, 8, 8]  # 100/50 x stride 4


def test_gif_lzw_property_roundtrip():
    """Encoder vs the independent decoder across adversarial patterns:
    all-zero (end-of-stream width edge), all-one, alternating, random, and
    lengths straddling code-width growth / the 4096 dictionary reset."""
    from pi_sph_fluid_tpu.io.display import GifSink

    rng = np.random.default_rng(11)
    cases = [
        bytes(64), b"\x01" * 64, bytes([0, 1] * 200),
        bytes(4097), b"\x01" * 70000,
        rng.integers(0, 2, size=70000).astype(np.uint8).tobytes(),
        rng.integers(0, 2, size=131).astype(np.uint8).tobytes(),
        bytes([1]), bytes([0, 0]),
    ]
    for data in cases:
        enc = GifSink._lzw(data, 2)
        dec = _gif_lzw_decode(enc, 2)
        assert bytes(dec) == data, f"LZW mismatch on case len={len(data)}"


def test_gif_sink_decodes_with_pillow(tmp_path):
    """Cross-check against a real-world third-party decoder (Pillow shares
    the code-width conventions of browser decoders): frames, geometry,
    per-frame delay, infinite loop, and exact pixels — including an
    all-dark frame (the end-of-stream code-width edge case)."""
    PIL_Image = pytest.importorskip("PIL.Image")
    from PIL import ImageSequence

    from pi_sph_fluid_tpu.io.display import GifSink
    from pi_sph_fluid_tpu.render.metaballs import unpack_framebuffer

    rng = np.random.default_rng(5)
    path = tmp_path / "pil.gif"
    sink = GifSink(str(path), rows=64, cols=128, scale=2, fps=20)
    pushed = [np.zeros(8 * 128, np.uint8),                      # all dark
              np.full(8 * 128, 0xFF, np.uint8),                 # all lit
              rng.integers(0, 256, size=8 * 128, dtype=np.uint8)]
    for fb in pushed:
        sink.push(fb)
    sink.close()

    im = PIL_Image.open(path)
    assert im.info.get("loop") == 0          # NETSCAPE loop-forever
    assert im.info.get("duration") == 50     # 100/20 x 10 ms
    frames = [np.array(f.convert("RGB")) for f in ImageSequence.Iterator(im)]
    assert len(frames) == 3 and frames[0].shape == (128, 256, 3)
    for fb, rgb in zip(pushed, frames):
        lit = np.all(rgb == (160, 210, 255), axis=-1)
        dark = np.all(rgb == (12, 14, 22), axis=-1)
        assert np.all(lit | dark)
        want = np.repeat(np.repeat(unpack_framebuffer(fb, 64, 128), 2, 0), 2, 1)
        np.testing.assert_array_equal(lit, want)


def test_frames_to_gif_tool(tmp_path):
    """The offline FileSink-capture -> GIF converter reproduces the frames
    (record headless on device, build the artifact later)."""
    import sys

    sys.path.insert(0, "/root/repo/tools")
    try:
        import frames_to_gif
    finally:
        sys.path.pop(0)

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(4, 8 * 128), dtype=np.uint8)
    cap = tmp_path / "frames.bin"
    cap.write_bytes(frames.tobytes())
    out = tmp_path / "out.gif"
    frames_to_gif.main([str(cap), str(out), "--scale", "1"])
    w, h, _, decoded = _parse_gif(out.read_bytes())
    assert (w, h) == (128, 64) and len(decoded) == 4
    from pi_sph_fluid_tpu.render.metaballs import unpack_framebuffer
    for fb, px in zip(frames, decoded):
        np.testing.assert_array_equal(
            np.asarray(px).reshape(h, w),
            unpack_framebuffer(fb, 64, 128).astype(np.uint8))


def test_web_sink_serves_frames():
    """The browser sink (SDL-window analog) must serve the page, the frame
    bytes, and the metadata on localhost."""
    import json as _json
    from urllib.request import urlopen

    from pi_sph_fluid_tpu.io.web import WebSink

    sink = WebSink(port=0, rows=64, cols=128)  # port 0: OS-assigned
    try:
        fb = np.arange(64 // 8 * 128, dtype=np.uint8)
        sink.push(fb)
        base = f"http://127.0.0.1:{sink.port}"
        page = urlopen(f"{base}/", timeout=5).read()
        assert b"canvas" in page
        meta = _json.loads(urlopen(f"{base}/meta", timeout=5).read())
        assert meta == {"rows": 64, "cols": 128, "frames": 1}
        got = urlopen(f"{base}/frame", timeout=5).read()
        assert got == fb.tobytes()
    finally:
        sink.close()


def test_web_gravity_tilt_roundtrip():
    """POST /gravity drives WebGravity exactly like an MPU sample
    (`pi_sph_fluid.c:431-464`): latest tilt x G, unit-disc clamped,
    (0, -G) before the first post, malformed posts rejected without
    clobbering the value."""
    import json as _json
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    from pi_sph_fluid_tpu.io.gravity import WebGravity
    from pi_sph_fluid_tpu.io.web import WebSink

    sink = WebSink(port=0)
    try:
        src = WebGravity(CFG, sink)
        g = CFG.g
        np.testing.assert_allclose(src.current(), [0.0, -g])  # pre-post default

        def post(body):
            return urlopen(Request(f"http://127.0.0.1:{sink.port}/gravity",
                                   data=body, method="POST"), timeout=5)

        assert post(_json.dumps({"tx": 0.5, "ty": -0.5}).encode()).status == 204
        np.testing.assert_allclose(src.current(), [0.5 * g, -0.5 * g], rtol=1e-6)
        tr = src.trace(4, CFG.dt)            # MPU semantics: batch = latest sample
        assert tr.shape == (4, 2)
        np.testing.assert_array_equal(tr, np.broadcast_to(tr[0], (4, 2)))
        # over-unit tilt is normalized server-side (belt to the page's clamp)
        post(_json.dumps({"tx": 3.0, "ty": 4.0}).encode())
        np.testing.assert_allclose(np.hypot(*src.current()), g, rtol=1e-6)
        for bad in (b"not json", _json.dumps({"tx": 1.0}).encode(),
                    _json.dumps({"tx": float("nan"), "ty": 0.0}).encode()):
            with pytest.raises(HTTPError) as exc:
                post(bad)
            assert exc.value.code == 400
        np.testing.assert_allclose(np.hypot(*src.current()), g, rtol=1e-6)
    finally:
        sink.close()


def test_web_gravity_drives_the_sim():
    """End-to-end interactivity: a browser tilt post steers the fluid (the
    reference's tilt-to-slosh demo without the hardware).  Sideways gravity
    posted through the HTTP path must accelerate the drop scene in +x."""
    import json as _json
    from urllib.request import Request, urlopen

    from pi_sph_fluid_tpu.io.gravity import WebGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.io.web import WebSink

    fluid, braw = build_drop_scene(CFG)
    sink = WebSink(port=0)
    try:
        urlopen(Request(f"http://127.0.0.1:{sink.port}/gravity",
                        data=_json.dumps({"tx": 1.0, "ty": 0.0}).encode(),
                        method="POST"), timeout=5)
        runner = SimRunner(CFG, fluid, braw, backend="reference", render=False)
        res = runner.run(WebGravity(CFG, sink), None,
                         sim_seconds=6 * CFG.dt, steps_per_dispatch=3)
        assert float(np.mean(np.asarray(res.sim.fluid.u))) > 0.0
    finally:
        sink.close()


def test_cli_web_gravity_needs_web_display():
    from pi_sph_fluid_tpu.cli import main

    with pytest.raises(SystemExit, match="--display web"):
        main(["run", "--scene", "drop", "--seconds", "0.01",
              "--backend", "reference", "--display", "none",
              "--gravity", "web"])


def test_generic_sph_operators_volume_factor():
    """sph_interpolate with volume leading factor: interpolating the constant
    1 over a full neighborhood gives ~1 (partition of unity, approximately)."""
    from pi_sph_fluid_tpu.ops.grid import build_grid
    from pi_sph_fluid_tpu.ops.neighbors import gather_candidates
    from pi_sph_fluid_tpu.ops.sph_operators import sph_gradient, sph_interpolate

    fluid, braw = build_drop_scene(CFG)
    boundary, bgrid = prepare_boundary(braw, CFG)
    grid = build_grid(fluid.x, fluid.y, CFG)
    fs = fluid.permute(grid.order)
    cand = gather_candidates(fs.x, fs.y, grid, CFG)
    ones = jnp.ones_like(fs.x)
    # use the true SPH density as rho so volume sums are meaningful
    from pi_sph_fluid_tpu.core.eos import tait_pressure
    from pi_sph_fluid_tpu.ops.density import density_pass

    cand_fb = gather_candidates(fs.x, fs.y, bgrid, CFG)
    rho = density_pass(fs, boundary, cand_fb=cand_fb, cand_ff=cand, cfg=CFG)
    interp = sph_interpolate(ones, fs.x, fs.y, fs.x, fs.y, fs.m, rho, cand, CFG,
                             leading_factor="volume", exclude_self=True)
    # interior particles: sum_j V_j W_ij ~ 1 - self-term share
    interior = np.asarray(interp)
    assert 0.5 < np.median(interior) < 1.05

    gx, gy = sph_gradient(ones, fs.x, fs.y, fs.x, fs.y, fs.m, rho, cand, CFG,
                          leading_factor="volume", exclude_self=True)
    # gradient of a constant is ~0 in the interior (boundary-deficient at edges)
    assert float(jnp.median(jnp.abs(gx))) < 5.0


def test_profiling_throughput_helper():
    from pi_sph_fluid_tpu.models.simulation import make_multi_step, prime
    from pi_sph_fluid_tpu.utils.profiling import device_memory, throughput

    fluid, braw = build_drop_scene(CFG)
    boundary, bgrid = prepare_boundary(braw, CFG)
    sim = prime(fluid, boundary, bgrid, (0.0, -9.81), CFG)
    multi = jax.jit(make_multi_step(CFG, boundary, bgrid))
    g = jnp.broadcast_to(jnp.asarray((0.0, -9.81), jnp.float32), (5, 2))
    ps, spt = throughput(multi, sim, g, fluid.n, repeats=2)
    assert ps > 0 and spt > 0
    device_memory()  # must not raise


def test_cli_checkpoint_roundtrip(tmp_path):
    from pi_sph_fluid_tpu.cli import main

    ckpt = str(tmp_path / "state.npz")
    main(["run", "--scene", "drop", "--seconds", "0.02", "--backend", "reference",
          "--display", "none", "--save-state", ckpt])
    main(["run", "--scene", "drop", "--seconds", "0.02", "--backend", "reference",
          "--display", "none", "--load-state", ckpt])


def test_cli_pallas_resume_is_bitwise(tmp_path):
    """The pallas --save-state npz must carry the raw
    layout arrays (packed, au, av — the leapfrog carry), and --load-state
    must resume from them VERBATIM: an 8-step run saved + resumed for 8
    more steps is bitwise identical to one continuous 16-step run.  A
    fluid-view re-prime cannot guarantee this (stable-sort ties break by
    id order instead of the previous layout order, shifting intra-cell
    summation order), which is why the raw arrays ride in the file."""
    import numpy as np

    from pi_sph_fluid_tpu.cli import main

    dt = CFG.dt
    half, cont, res = (str(tmp_path / f) for f in
                       ("half.npz", "cont.npz", "res.npz"))
    base = ["run", "--scene", "drop", "--backend", "pallas", "--interpret",
            "--display", "none", "--steps-per-dispatch", "4"]
    main(base + ["--seconds", repr(8 * dt), "--save-state", half])
    main(base + ["--seconds", repr(16 * dt), "--save-state", cont])
    main(base + ["--seconds", repr(8 * dt), "--load-state", half,
                 "--save-state", res])

    a, b = np.load(cont), np.load(res)
    assert "packed" in a and "au" in a   # the carry is persisted
    for key in ("packed", "au", "av", "ids", "fluid.x", "fluid.u"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_simrunner_pallas_render_dispatch(tmp_path):
    """The production dispatch path (sticky multi + frame reuse renderer +
    overflow folding + pipelined fetch) end-to-end in interpret mode."""
    import numpy as np

    from pi_sph_fluid_tpu.io.display import FileSink
    from pi_sph_fluid_tpu.io.gravity import ConstantGravity
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_drop_scene

    fluid, braw = build_drop_scene(CFG)
    runner = SimRunner(CFG, fluid, braw, backend="pallas",
                       engine_opts=dict(qb=8, cap=256, seg_q=2,
                                        interpret=True),
                       render=True, resort_every=2)
    path = tmp_path / "frames.bin"
    sink = FileSink(str(path))
    res = runner.run(ConstantGravity(CFG), sink,
                     sim_seconds=8 * CFG.dt, steps_per_dispatch=4)
    sink.close()
    assert res.steps == 8
    assert res.reporter.total_overflow == 0
    frames = np.fromfile(path, np.uint8)
    assert frames.size == 2 * 1024       # 2 dispatches -> 2 frames
    assert frames.any()                  # something was drawn


def test_autocap_recovery_replays_clean():
    """Elastic capacity recovery: a cap the dam scene overflows (128 — see
    test_window_engine.test_window_overflow_reported_not_silent) must be
    detected, the engine rebuilt with a doubled cap, and the dirty interval
    replayed — the final run reports ZERO overflow and matches a run that
    started at the recovered cap.  A *stateful* gravity source (rotating)
    exercises the trace-replay log: the replayed interval must see the very
    traces it saw the first time, and post-replay dispatches must continue
    the source's clock without a gap."""
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene

    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg)
    log = io.StringIO()
    runner = SimRunner(cfg, fluid, braw, backend="pallas",
                       engine_opts=dict(qb=16, cap=128, seg_q=2,
                                        interpret=True),
                       render=False, max_cap=512)
    res = runner.run(RotatingGravity(cfg, period_s=0.05),
                     sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert res.recoveries >= 1
    assert runner.engine.spec.cap > 128
    assert res.reporter.total_overflow == 0
    assert "WINDOW OVERFLOW" in log.getvalue()

    # a fresh run that starts at the recovered cap, driven by an identical
    # fresh gravity source, must agree exactly
    clean = SimRunner(cfg, fluid, braw, backend="pallas",
                      engine_opts=dict(qb=16, seg_q=2, interpret=True,
                                       cap=runner.engine.spec.cap),
                      render=False, auto_cap=False)
    res2 = clean.run(RotatingGravity(cfg, period_s=0.05),
                     sim_seconds=8 * cfg.dt, steps_per_dispatch=4)
    a = runner.engine.unpad(res.sim)
    b = clean.engine.unpad(res2.sim)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(np.asarray(a.rho), np.asarray(b.rho))


def test_autocap_ceiling_keeps_counting():
    """At the max-cap ceiling the runner stops recovering but the overflow
    count stays visible (never-silent invariant)."""
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene

    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg)
    log = io.StringIO()
    runner = SimRunner(cfg, fluid, braw, backend="pallas",
                       engine_opts=dict(qb=16, cap=128, seg_q=2,
                                        interpret=True),
                       render=False, max_cap=128)
    res = runner.run(ConstantGravity(cfg), sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert res.recoveries == 0
    assert res.reporter.total_overflow > 0
    assert "max-cap reached" in log.getvalue()


def test_autocap_settle_recovery():
    """Settle-phase overflow must also trigger recovery: the damped pre-roll
    restarts under the doubled cap (it would otherwise corrupt the initial
    checkpoint invisibly — settle stats used to be discarded)."""
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene

    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg)
    log = io.StringIO()
    runner = SimRunner(cfg, fluid, braw, backend="pallas",
                       engine_opts=dict(qb=16, cap=128, seg_q=2,
                                        interpret=True),
                       render=False, max_cap=512)
    res = runner.run(ConstantGravity(cfg), sim_seconds=4 * cfg.dt,
                     steps_per_dispatch=4, settle_seconds=4 * cfg.dt,
                     report_stream=log)
    assert res.recoveries >= 1
    assert "during settle" in log.getvalue()
    assert res.reporter.total_overflow == 0


def test_autocap_recovery_with_renderer(tmp_path):
    """Recovery under a rendered run: the pre-revert frames already pushed
    stay (tearing-tolerant display contract), the pending frame is
    discarded, and the replay re-pushes corrected frames — the LAST frame
    must equal a clean fixed-cap run's last frame."""
    from pi_sph_fluid_tpu.io.display import FileSink
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_drop_scene

    cfg = SPHConfig()
    fluid, braw = build_drop_scene(cfg)
    runner = SimRunner(cfg, fluid, braw, backend="pallas",
                       engine_opts=dict(qb=16, cap=128, seg_q=2,
                                        interpret=True),
                       render=True, max_cap=512)
    p1 = tmp_path / "recovered.bin"
    sink = FileSink(str(p1))
    res = runner.run(ConstantGravity(cfg), sink, sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4)
    sink.close()
    assert res.recoveries >= 1
    assert res.reporter.total_overflow == 0

    clean = SimRunner(cfg, fluid, braw, backend="pallas",
                      engine_opts=dict(qb=16, seg_q=2, interpret=True,
                                       cap=runner.engine.spec.cap),
                      render=True, auto_cap=False)
    p2 = tmp_path / "clean.bin"
    sink2 = FileSink(str(p2))
    clean.run(ConstantGravity(cfg), sink2, sim_seconds=8 * cfg.dt,
              steps_per_dispatch=4)
    sink2.close()
    rec = np.fromfile(p1, np.uint8).reshape(-1, 1024)
    ref = np.fromfile(p2, np.uint8).reshape(-1, 1024)
    assert rec.shape[0] >= ref.shape[0]      # replay re-pushes frames
    assert (rec[-1] == ref[-1]).all()


def test_autocap_recovery_with_resume():
    """Revert when the start checkpoint is a RESUMED state: the runner must
    reuse the resume snapshot (never re-prime, which would restart the
    scene) and replay it under the grown cap — final state matches running
    the same resume under the recovered cap from the start."""
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_dam_break_scene

    cfg = SPHConfig()
    fluid, braw = build_dam_break_scene(cfg)
    warm = SimRunner(cfg, fluid, braw, backend="pallas",
                     engine_opts=dict(qb=16, cap=256, seg_q=2,
                                      interpret=True),
                     render=False, auto_cap=False)
    res0 = warm.run(ConstantGravity(cfg), sim_seconds=4 * cfg.dt,
                    steps_per_dispatch=4)

    log = io.StringIO()
    runner = SimRunner(cfg, fluid, braw, backend="pallas",
                       engine_opts=dict(qb=16, cap=128, seg_q=2,
                                        interpret=True),
                       render=False, max_cap=512)
    res = runner.run(ConstantGravity(cfg), sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4, resume=res0.sim,
                     report_stream=log)
    assert res.recoveries >= 1
    assert res.reporter.total_overflow == 0

    clean = SimRunner(cfg, fluid, braw, backend="pallas",
                      engine_opts=dict(qb=16, seg_q=2, interpret=True,
                                       cap=runner.engine.spec.cap),
                      render=False, auto_cap=False)
    res2 = clean.run(ConstantGravity(cfg), sim_seconds=8 * cfg.dt,
                     steps_per_dispatch=4, resume=res0.sim)
    a = runner.engine.unpad(res.sim)
    b = clean.engine.unpad(res2.sim)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))


def test_next_cap_ladder():
    """The escalation ladder steps 1.5x rounded up to the 128-lane quantum,
    clamped at max_cap."""
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_drop_scene

    fluid, braw = build_drop_scene(CFG)
    r = SimRunner(CFG, fluid, braw, backend="pallas", render=False,
                  engine_opts=dict(qb=16, cap=128, seg_q=2,
                                   interpret=True),
                  max_cap=1024)
    assert [r._next_cap(c) for c in (128, 256, 384, 512, 896)] == \
        [256, 384, 640, 768, 1024]


def test_render_shape_plumbs_to_renderer_and_sinks(tmp_path):
    """--render-shape end-to-end at a non-default 32x64: the runner's
    framebuffer is 32*64/8 = 256 bytes, the PNG sink emits 32s x 64s
    images, and the terminal/file sinks unpack with the same geometry
    (PngSink once hardcoded 64x128)."""
    import struct
    import zlib

    from pi_sph_fluid_tpu.io.display import FileSink, PngSink
    from pi_sph_fluid_tpu.io.host_loop import SimRunner
    from pi_sph_fluid_tpu.models.scene import build_drop_scene
    from pi_sph_fluid_tpu.render.metaballs import unpack_framebuffer

    cfg = SPHConfig()
    fluid, braw = build_drop_scene(cfg)
    runner = SimRunner(cfg, fluid, braw, backend="pallas",
                       engine_opts=dict(qb=8, cap=256, seg_q=2,
                                        interpret=True),
                       render=True, render_shape=(32, 64))
    p = tmp_path / "frames.bin"
    sink = FileSink(str(p))
    runner.run(ConstantGravity(cfg), sink, sim_seconds=6 * cfg.dt,
               steps_per_dispatch=3)
    sink.close()
    raw = p.read_bytes()
    assert len(raw) > 0 and len(raw) % 256 == 0   # 32*64/8-byte frames
    last = np.frombuffer(raw[-256:], np.uint8)
    img = unpack_framebuffer(last, 32, 64)
    assert img.shape == (32, 64)
    assert img.any() and not img.all()            # the blob is visible

    png = PngSink(str(tmp_path / "f"), 32, 64, scale=2)
    png.push(last)
    png.close()
    data = (tmp_path / "f_000000.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])      # IHDR width/height
    assert (h, w) == (32 * 2, 64 * 2)
    zlib.decompress(data[data.index(b"IDAT") + 4:-12])  # well-formed stream
