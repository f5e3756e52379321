"""Live interactive viewer: the reference's real-time window, served.

The reference's defining runtime behavior is a GLFW window redrawn every
vsync — ``while !glfwWindowShouldClose: draw(); swapBuffers; pollEvents``
(main.cpp:47-93, swap loop :81-86) with the wall clock as the scene's sole
animation input (main.cpp:111-118). A GPU server is headless, so the swap
chain becomes an HTTP MJPEG stream: a producer thread renders
``reference_frame(wall_time)`` as fast as the device allows (or an --fps cap,
the vsync analog) and every connected browser shows the latest frame via
``multipart/x-mixed-replace`` — a live, interactive view with an FPS
readout, no client software needed.

Endpoints:
  /           HTML page: the live stream + FPS/stats overlay
  /stream     MJPEG multipart stream of rendered frames
  /frame.jpg  single latest frame
  /stats      JSON {frame, fps, width, height, depth, engine}

The render loop matches cmd_animate's semantics (same engines incl. culled
with per-frame overflow recheck) but is driven by the wall clock like the
reference, not a fixed frame index.

PIPELINED PRODUCER: device render, host fetch and JPEG encode do not run
back-to-back. The producer is a depth-N pipeline: the dispatch loop
enqueues device work asynchronously (JAX dispatch returns before the device
finishes) and a pool of fetch/encode workers each pull a finished frame to
host and encode it CONCURRENTLY — the device renders frame N+1 while
workers fetch and encode N and N-1. Publishes are forced in-order so
consumers never see time run backwards.
"""

from __future__ import annotations

import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_BOUNDARY = "oglrtframe"


class FrameStreamer:
    """Producer thread: renders the animated reference world at wall time t
    and holds the latest JPEG for any number of stream consumers."""

    def __init__(self, height: int = 360, width: int = 640, depth: int = 0,
                 engine: str = "auto", cull_tile: int = 8,
                 fps_cap: float | None = None, max_frames: int | None = None,
                 start_time: float = 0.0, quality: int = 85,
                 pipeline_depth: int = 3, transport: str = "auto"):
        self.height, self.width = height, width
        self.depth, self.engine = depth, engine
        # transport: what crosses the device->host link per frame.
        #   'rgb'    - (H, W, 3) uint8 (3 B/px)
        #   'yuv420' - device-subsampled Y + half-res Cb/Cr (1.5 B/px) —
        #              lossless vs the 4:2:0 JPEG the consumer sees anyway
        #   'auto'   - yuv420 when both dims are even, else rgb
        if transport == "auto":
            transport = "yuv420" if height % 2 == 0 and width % 2 == 0 \
                else "rgb"
        assert transport in ("rgb", "yuv420"), transport
        if transport == "yuv420":
            assert height % 2 == 0 and width % 2 == 0, \
                "yuv420 transport needs even frame dimensions"
        self.transport = transport
        self.cull_tile = cull_tile
        self.fps_cap = fps_cap
        self.max_frames = max_frames
        self.start_time = start_time
        self.quality = quality
        self.pipeline_depth = max(1, pipeline_depth)
        self.frame_no = 0
        self.fps = 0.0
        self.error: BaseException | None = None
        self._jpeg: bytes | None = None
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cull = None
        self._next_pub = 0        # next sequence number to publish
        self._rebuild = False     # a worker saw cull overflow

    # -- producer ----------------------------------------------------------
    def _render_setup(self):
        from openglraytracer_tpu.models.animated import reference_frame
        if self.engine in ("culled", "culled_pallas"):
            from openglraytracer_tpu.ops.accel import suggest_cull_config
            t = self.cull_tile
            if self.height % t or self.width % t:
                raise ValueError(f"cull tile {t} must divide the frame "
                                 f"{self.width}x{self.height}")
            s0, c0 = reference_frame(self.start_time)
            self._cull = suggest_cull_config(s0, c0, self.height, self.width,
                                             (t, t), headroom=2.0)
        self._frame_fn = self._build_frame_fn()

    def _build_frame_fn(self):
        """ONE jitted function of the wall-clock t: scene build + render +
        uint8 quantize all on device: one dispatch and one fetch per
        frame instead of a host round-trip per stage. Static shadow/bounce
        masks are
        decided once from the concrete t=start scene (light/material
        STRUCTURE is time-invariant in the animated world); overflow comes
        back as a device scalar, checked per frame without a recount pass."""
        import jax

        from openglraytracer_tpu.models.animated import reference_frame
        from openglraytracer_tpu.ops.render import render
        from openglraytracer_tpu.ops.shading import (static_bounce_mask,
                                                     static_shadow_mask)
        from openglraytracer_tpu.utils.image import (pack_yuv420_device,
                                                     to_uint8_device)

        s0, _ = reference_frame(self.start_time)
        sm = static_shadow_mask(s0)
        bm = static_bounce_mask(s0) if self.depth > 0 else (True, True)
        cull = self._cull
        yuv = self.transport == "yuv420"

        import jax.numpy as jnp

        @jax.jit
        def frame(t):
            scene, cam = reference_frame(t)
            img, ovf = render(scene, cam, self.height, self.width,
                              depth=self.depth, engine=self.engine,
                              cull=cull, shadow_lights=sm, bounce_mask=bm,
                              with_cull_stats=True)
            out = pack_yuv420_device(img) if yuv else to_uint8_device(img)
            if yuv and cull is not None:
                # ride the overflow flag in the SAME packed fetch: a
                # separate int(ovf) sync would cost one more device->host
                # round-trip per frame
                out = jnp.concatenate(
                    [out, jnp.minimum(ovf, 255).astype(jnp.uint8)[None]])
            return out, ovf

        return frame

    def _rebuild_cull(self, t: float):
        """The moving scene outgrew the static K lists: resize from the
        current frame and rebuild (multiples of 16 bound recompile thrash,
        ADVICE r2). Called from the DISPATCH loop only (between frames, with
        the pipeline drained) so no worker holds a stale frame_fn's output.
        The overflowed frames still showed (conservative superset semantics
        — only the overflowed tiles may drop objects, never silent)."""
        from openglraytracer_tpu.models.animated import reference_frame
        from openglraytracer_tpu.ops.accel import suggest_cull_config
        scene, cam = reference_frame(t)
        cull = suggest_cull_config(scene, cam, self.height, self.width,
                                   self._cull[0], headroom=2.0)
        self._cull = (cull[0],) + tuple(
            -(-k // 16) * 16 if k else k for k in cull[1:])
        self._frame_fn = self._build_frame_fn()

    def _finish(self, seq: int, t: float, dev, ovf) -> None:
        """Fetch/encode worker: device->host transfer + JPEG encode run
        CONCURRENTLY across pipeline_depth workers; publish is serialized by
        sequence number so the stream never goes backwards in time."""
        import numpy as np
        from PIL import Image

        from openglraytracer_tpu.utils.image import (unpack_yuv420,
                                                     yuv420_to_jpeg)
        try:
            host = np.asarray(dev)                  # ONE blocking D2H fetch
            if self._cull is not None:
                if self.transport == "yuv420":      # ovf rode the packed buf
                    if host[-1] > 0:
                        self._rebuild = True
                    host = host[:-1]
                elif int(ovf) > 0:
                    self._rebuild = True            # dispatch loop handles it
            if self.transport == "yuv420":
                jpeg = yuv420_to_jpeg(
                    *unpack_yuv420(host, self.height, self.width),
                    quality=self.quality)
            else:
                buf = io.BytesIO()
                Image.fromarray(host).save(buf, "JPEG",
                                           quality=self.quality)
                jpeg = buf.getvalue()
            with self._cond:
                self._cond.wait_for(
                    lambda: self._next_pub == seq or self._stop.is_set())
                if self._next_pub == seq:
                    now = time.monotonic()
                    w = self._window
                    w.append(now)
                    while w and now - w[0] > 2.0:
                        w.pop(0)
                    self._jpeg = jpeg
                    self.frame_no += 1
                    self._next_pub += 1
                    self.fps = len(w) / max(now - w[0], 1e-6) \
                        if len(w) > 1 else 0.0
                self._cond.notify_all()
        except BaseException as e:
            import traceback
            traceback.print_exc()
            self.error = e
            self._stop.set()
            with self._cond:
                self._cond.notify_all()

    def _loop(self):
        try:
            self._loop_inner()
        except BaseException as e:           # surface producer crashes:
            import traceback                 # a daemon thread dying silently
            traceback.print_exc()            # looks like a 0-FPS hang
            self.error = e
            self._stop.set()
            with self._cond:
                self._cond.notify_all()

    def _drain(self, futures) -> None:
        for f in futures:
            f.result()
        futures.clear()

    def _loop_inner(self):
        import jax.numpy as jnp

        self._render_setup()
        self._window: list[float] = []
        t0 = time.monotonic()
        seq = 0
        futures: list = []
        with ThreadPoolExecutor(self.pipeline_depth) as pool:
            while not self._stop.is_set():
                if self.max_frames is not None and seq >= self.max_frames:
                    break
                if self._rebuild:
                    self._drain(futures)      # no stale frame_fn in flight
                    self._rebuild = False
                    self._rebuild_cull(self.start_time
                                       + (time.monotonic() - t0))
                # bound frames in flight: wait for the oldest worker once
                # pipeline_depth dispatches are pending
                while len(futures) >= self.pipeline_depth:
                    futures.pop(0).result()
                tick = time.monotonic()
                dev, ovf = self._frame_fn(
                    jnp.float32(self.start_time + (tick - t0)))
                futures.append(pool.submit(self._finish, seq, tick, dev,
                                           ovf))
                seq += 1
                if self.fps_cap:
                    budget = 1.0 / self.fps_cap - (time.monotonic() - tick)
                    if budget > 0:
                        time.sleep(budget)
            self._drain(futures)
        with self._cond:           # wake any /stream waiters so they exit
            self._cond.notify_all()

    # -- lifecycle / consumers --------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    @property
    def done(self) -> bool:
        return self._stop.is_set() or (
            self.max_frames is not None and self.frame_no >= self.max_frames)

    def wait_frame(self, after: int, timeout: float = 60.0):
        """Block until frame_no > after (or the stream ends); return the
        latest (frame_no, jpeg)."""
        with self._cond:
            self._cond.wait_for(lambda: self.frame_no > after or self.done,
                                timeout=timeout)
            return self.frame_no, self._jpeg

    def stats(self) -> dict:
        return {"frame": self.frame_no, "fps": round(self.fps, 1),
                "width": self.width, "height": self.height,
                "depth": self.depth, "engine": self.engine,
                "transport": self.transport}


_PAGE = """<!doctype html>
<title>oglrt view</title>
<body style="margin:0;background:#111;color:#eee;font:14px monospace">
<div id="s" style="padding:4px"></div>
<img src="/stream" style="image-rendering:pixelated">
<script>
setInterval(async () => {
  const r = await fetch('/stats'); const j = await r.json();
  document.getElementById('s').textContent =
    `frame ${j.frame}  ${j.fps} FPS  ${j.width}x${j.height}` +
    `  depth=${j.depth}  engine=${j.engine}`;
}, 500);
</script>
"""


def _make_handler(streamer: FrameStreamer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            try:
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stats":
                    body = json.dumps(streamer.stats()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/frame.jpg":
                    _, jpeg = streamer.wait_frame(0)
                    if jpeg is None:
                        self.send_error(503, "no frame yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        f"multipart/x-mixed-replace; boundary={_BOUNDARY}")
                    self.end_headers()
                    seen = 0
                    while True:
                        n, jpeg = streamer.wait_frame(seen)
                        if jpeg is None or (n == seen and streamer.done):
                            break
                        seen = n
                        self.wfile.write(
                            f"--{_BOUNDARY}\r\nContent-Type: image/jpeg\r\n"
                            f"Content-Length: {len(jpeg)}\r\n\r\n".encode())
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                        if streamer.done:
                            break
                else:
                    self.send_error(404)
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away — the reference closes its window too

    return Handler


def serve(streamer: FrameStreamer, port: int = 0,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start the HTTP server (not the render loop) on the given port
    (0 = ephemeral); returns the server — run serve_forever() yourself or in
    a thread. ``server.server_address[1]`` is the bound port."""
    server = ThreadingHTTPServer((host, port), _make_handler(streamer))
    server.daemon_threads = True
    return server


def run_viewer(height: int, width: int, depth: int = 0, engine: str = "auto",
               cull_tile: int = 8, port: int = 8000,
               fps_cap: float | None = None,
               max_frames: int | None = None, start_time: float = 0.0):
    """The blocking CLI entry: render loop + HTTP server until Ctrl-C (or
    max_frames). Prints a console FPS readout once per second — the honest
    replacement for the reference's vsync-hidden frame cost (main.cpp:76)."""
    streamer = FrameStreamer(height, width, depth, engine, cull_tile,
                             fps_cap, max_frames, start_time).start()
    server = serve(streamer, port)
    bound = server.server_address[1]
    print(f"oglrt view: http://localhost:{bound}/  "
          f"({width}x{height}, depth={depth}, engine={engine})")
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    try:
        last = -1
        while not streamer.done:
            time.sleep(1.0)
            if streamer.frame_no != last:
                last = streamer.frame_no
                print(f"frame {streamer.frame_no}  {streamer.fps:.1f} FPS",
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        streamer.stop()
        server.shutdown()
    return streamer
