"""Capture live-viewer FPS on the GPU: drive the FrameStreamer (the
`oglrt view` producer loop) for ~10 s of wall clock at 1280x720 on the
animated reference world and write the /stats JSON to
artifacts/viewer_fps.json (gitignored).

    python scripts/viewer_fps_capture.py

The reference locks to vsync and hides its true frame cost
(main.cpp:76 glfwSwapInterval(1)); this capture reports the honest number:
device render + host fetch + JPEG encode per frame, wall-clock driven.
"""
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openglraytracer_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from openglraytracer_tpu.utils.viewer import FrameStreamer  # noqa: E402

enable_compile_cache()

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts", "viewer_fps.json")
SECONDS = 10.0


def capture(engine: str, height=720, width=1280, depth=0, cull_tile=16):
    s = FrameStreamer(height=height, width=width, depth=depth, engine=engine,
                      cull_tile=cull_tile).start()
    # skip the jit-compile frame: wait for frame 1, then time a clean window
    s.wait_frame(0, timeout=600.0)
    f0 = s.frame_no
    t0 = time.monotonic()
    time.sleep(SECONDS)
    f1 = s.frame_no
    t1 = time.monotonic()
    stats = s.stats()
    s.stop()
    stats["frames_in_window"] = f1 - f0
    stats["window_seconds"] = round(t1 - t0, 2)
    stats["fps_window"] = round((f1 - f0) / (t1 - t0), 1)
    return stats


def decompose(height=720, width=1280):
    """Per-frame pipeline decomposition: device render (fused jitted frame)
    vs host fetch vs JPEG encode — separates the renderer's capability from
    the device->host link."""
    import numpy as np
    import jax.numpy as jnp
    from openglraytracer_tpu.utils.image import unpack_yuv420, yuv420_to_jpeg
    from openglraytracer_tpu.utils.viewer import FrameStreamer

    out = {}
    for transport in ("rgb", "yuv420"):
        s = FrameStreamer(height=height, width=width, engine="xla",
                          transport=transport)
        s._render_setup()
        fn = s._frame_fn
        jax.block_until_ready(fn(jnp.float32(0.0)))
        ts_dev, ts_fetch = [], []
        for i in range(8):
            t0 = time.monotonic()
            dev, ovf = fn(jnp.float32(0.1 * i + 0.05))
            jax.block_until_ready(dev)
            t1 = time.monotonic()
            host = np.asarray(dev)     # ONE packed fetch
            t2 = time.monotonic()
            ts_dev.append(t1 - t0)
            ts_fetch.append(t2 - t1)
        t0 = time.monotonic()
        for _ in range(5):
            if transport == "yuv420":
                yuv420_to_jpeg(*unpack_yuv420(host, height, width),
                               quality=85)
            else:
                import io
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(host).save(buf, "JPEG", quality=85)
        jpeg_s = (time.monotonic() - t0) / 5
        dev_s, fetch_s = min(ts_dev), min(ts_fetch)
        out[transport] = {
            "device_frame_ms": round(dev_s * 1e3, 1),
            "host_fetch_ms": round(fetch_s * 1e3, 1),
            "jpeg_encode_ms": round(jpeg_s * 1e3, 1),
            "fetch_bytes": int(host.nbytes),
            "implied_local_host_fps": round(1.0 / (dev_s + jpeg_s), 1),
        }
    return out


def main():
    rows = {}
    for engine, h, w in (("xla", 720, 1280), ("culled_pallas", 720, 1280),
                         ("xla_360p", 360, 640)):
        eng = engine.split("_360p")[0]
        rows[engine] = capture(eng, height=h, width=w)
        print(json.dumps(rows[engine]), flush=True)
    out = {"scene": "reference animated world (raytrace_compute.glsl:261-320)",
           "seconds_per_engine": SECONDS,
           "device": {"platform": jax.devices()[0].platform,
                      "kind": jax.devices()[0].device_kind,
                      "count": len(jax.devices())},
           "engines": rows,
           "pipeline_720p": decompose()}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
