#!/usr/bin/env python3
"""Convert a FileSink capture (raw concatenated page-packed framebuffers,
``--display file:frames.bin``) into one looping animated GIF offline.

Record on the accelerator headless — the file sink costs ~1 KB/frame and never
blocks the dispatch loop — then build the shareable artifact later:

    python tools/frames_to_gif.py /tmp/frames.bin demo.gif --rows 64 --cols 128
"""

from __future__ import annotations

import argparse

import numpy as np

from pi_sph_fluid_tpu.io.display import GifSink


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("frames_bin", help="FileSink capture (raw packed frames)")
    ap.add_argument("gif_out")
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--cols", type=int, default=128)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--max-frames", type=int, default=1800,
                    help="longer captures auto-decimate 2x to stay bounded")
    args = ap.parse_args(argv)

    frame_bytes = args.rows // 8 * args.cols
    raw = np.fromfile(args.frames_bin, np.uint8)
    if len(raw) == 0 or len(raw) % frame_bytes:
        raise SystemExit(f"{args.frames_bin}: {len(raw)} bytes is not a "
                         f"whole number of {args.rows}x{args.cols} frames "
                         f"({frame_bytes} B each) — check --rows/--cols")
    sink = GifSink(args.gif_out, args.rows, args.cols, scale=args.scale,
                   fps=args.fps, max_frames=args.max_frames)
    for frame in raw.reshape(-1, frame_bytes):
        sink.push(frame)
    sink.close()


if __name__ == "__main__":
    main()
