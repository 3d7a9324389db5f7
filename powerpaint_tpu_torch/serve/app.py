"""Web serving: the Gradio UI when gradio is installed, a stdlib HTTP server
otherwise (the port of ``powerpaint_tpu/serve/app.py``).

The reference serves a Gradio Blocks UI (app.py:563-749). Without gradio a
dependency-free HTTP server exposes the same four tasks:

    GET  /            minimal HTML form
    GET  /health      {"status": "ok"}
    POST /inpaint     JSON {image_b64, mask_b64, prompt, task, ...} -> PNG
                      (num_images > 1 -> JSON {"images": [png_b64, ...]},
                      the HTTP form of the reference's result gallery)

Input errors answer 400 with {"error": ...}. Without micro-batching
requests are serialized through a lock (the reference equivalently
serializes through ``demo.queue()``, app.py:748); with it, concurrent
requests coalesce into batched calls (``serve.batcher``).

Canvases are padded to 64-px buckets by default, as in the JAX package
(``{"bucket": false}`` turns it off): the port has no compile to save, but
the padding changes the image, so dropping it would change the function.
"""

from __future__ import annotations

import base64
import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_HTML = """<!doctype html>
<title>PowerPaint</title>
<h1>PowerPaint inpainting (PyTorch)</h1>
<p>POST JSON to /inpaint with fields: image_b64, mask_b64, prompt, task
(text-guided | shape-guided | object-removal | image-outpainting),
fitting_degree, steps, guidance_scale, seed, num_images.</p>
"""


def _decode_image(b64: str):
    from PIL import Image

    from powerpaint_tpu_torch.tasks.preprocess import to_numpy_image

    return to_numpy_image(Image.open(io.BytesIO(base64.b64decode(b64))))


def _run_request(pipe, payload: dict) -> tuple:
    """Returns ``(content_type, body_bytes)``."""
    import numpy as np
    from PIL import Image

    from powerpaint_tpu_torch.tasks.postprocess import blend_result
    from powerpaint_tpu_torch.tasks.preprocess import (
        crop_from_bucket,
        crop_to_multiple_of_8,
        outpaint_canvas,
        pad_to_bucket,
        resize_short_side,
        resize_to,
        to_numpy_mask,
    )

    image = _decode_image(payload["image_b64"])
    task = payload.get("task", "text-guided")
    short = int(payload.get("short_side", 512 if task == "image-outpainting"
                            else 640))
    image = resize_short_side(image, short)
    if task == "image-outpainting":
        image, mask = outpaint_canvas(
            image,
            float(payload.get("horizontal_expansion", 1.5)),
            float(payload.get("vertical_expansion", 1.5)),
        )
    else:
        mask = to_numpy_mask(
            Image.open(io.BytesIO(base64.b64decode(payload["mask_b64"])))
        )
        if mask.shape[:2] != image.shape[:2]:
            pil = Image.fromarray((mask * 255).astype(np.uint8))
            mask = np.asarray(
                pil.resize((image.shape[1], image.shape[0]))
            ).astype(np.float32) / 255.0
    image = crop_to_multiple_of_8(image)
    mask = mask[: image.shape[0], : image.shape[1]]

    # exact target resolution (reference height/width call args): resize
    # here so compositing sees the same canvas; disables bucketing
    if "height" in payload and "width" in payload:
        image, mask = resize_to(image, mask, int(payload["height"]),
                                int(payload["width"]))

    # pad to 64px size buckets by default; disable with {"bucket": false}
    orig_hw = None
    if payload.get("bucket", True) and "height" not in payload:
        image, mask, orig_hw = pad_to_bucket(image, mask)
        if orig_hw == image.shape[:2]:
            orig_hw = None

    # full per-request surface (reference UI fields, app.py:527-583):
    # scheduler/strength/eta/clip_skip plus ControlNet and IP-Adapter
    # inputs; unsupported-by-this-pipeline kwargs raise -> HTTP 400
    extra = {}
    for name, cast in (("scheduler", str), ("strength", float),
                       ("eta", float), ("clip_skip", int),
                       ("ip_adapter_scale", float),
                       ("guess_mode", bool),
                       ("controlnet_conditioning_scale", float),
                       ("brushnet_conditioning_scale", float),
                       ("control_guidance_start", float),
                       ("control_guidance_end", float),
                       ("encoder_cache_interval", int),
                       ("branch_cache_interval", int)):
        if name in payload:
            extra[name] = cast(payload[name])
    if "control_image_b64" in payload:
        ctrl = _decode_image(payload["control_image_b64"])
        if ctrl.shape[:2] != image.shape[:2]:
            ctrl = np.asarray(Image.fromarray(ctrl).resize(
                (image.shape[1], image.shape[0])
            ))
        ctype = payload.get("control_type")
        if ctype:  # run the named preprocessor (canny/depth/hed/pose)
            from powerpaint_tpu_torch.tasks.control import get_control_image

            ctrl = get_control_image(ctype, ctrl)
        extra["control_image"] = ctrl
    if "ip_adapter_image_b64" in payload:
        extra["ip_adapter_image"] = _decode_image(
            payload["ip_adapter_image_b64"])

    n_images = int(payload.get("num_images", 1))
    if n_images > 1:
        extra["num_images_per_prompt"] = n_images
    out = pipe(
        image, mask,
        prompt=payload.get("prompt", ""),
        negative_prompt=payload.get("negative_prompt", ""),
        task=task,
        fitting_degree=float(payload.get("fitting_degree", 1.0)),
        num_inference_steps=int(payload.get("steps", 45)),
        guidance_scale=float(payload.get("guidance_scale", 7.5)),
        seed=int(payload.get("seed", 0)),
        **extra,
    )

    def _to_png(result) -> bytes:
        final = blend_result(result, image, mask)
        if orig_hw is not None:
            final = crop_from_bucket(final, orig_hw)
        buf = io.BytesIO()
        Image.fromarray(np.asarray(final)).save(buf, format="PNG")
        return buf.getvalue()

    if n_images > 1:  # the HTTP form of the reference's result gallery
        body = json.dumps({
            "images": [
                base64.b64encode(_to_png(out[i])).decode()
                for i in range(out.shape[0])
            ]
        }).encode()
        return "application/json", body
    return "image/png", _to_png(out[0])


class _BatchedPipe:
    """Pipeline adapter that routes single-image calls through a
    MicroBatcher (``serve.batcher``) so concurrent HTTP requests coalesce
    into one batched generate. A multi-image request runs directly, under
    the batcher's dispatch lock: the port's pipelines are not safe to call
    from two threads at once."""

    def __init__(self, batcher):
        self._batcher = batcher

    def __call__(self, image, mask, **kwargs):
        if kwargs.get("num_images_per_prompt", 1) > 1:
            # multi-image requests carry their own batch; run directly
            with self._batcher.lock:
                return self._batcher.pipe(image, mask, **kwargs)
        return self._batcher.submit(image, mask, **kwargs)[None]


class _Server(ThreadingHTTPServer):
    """The HTTP server; ``batcher`` is its MicroBatcher (None without
    micro-batching), closed with the server."""

    batcher = None

    def server_close(self):
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()


def make_server(
    pipe, port: int = 7860, micro_batch: int = 0, on_first_success=None
) -> ThreadingHTTPServer:
    """``micro_batch`` > 1 coalesces concurrent /inpaint requests into one
    batched generate (the v1, v2 and ControlNet pipelines have the
    multi-request form; requests with per-call-only features (eta>0,
    IP-Adapter inputs, given latents) run alone). ``port`` 0 takes a free
    port (``server.server_address[1]``)."""
    lock = threading.Lock()
    first_done = [on_first_success is None]
    batcher = None

    def _first_hook_locked():
        """Run the first-success hook (the --aot-cache dump) once, while
        still holding the request lock."""
        if first_done[0]:
            return
        first_done[0] = True
        try:
            on_first_success()
        except Exception as e:  # never fail the request for a cache dump
            print(f"aot: post-request hook failed: {e}", file=sys.stderr)

    if micro_batch > 1:
        from powerpaint_tpu_torch.serve.batcher import MicroBatcher

        batcher = MicroBatcher(pipe, max_batch=micro_batch)
        batched = _BatchedPipe(batcher)
        if not first_done[0]:
            # as in the JAX package: the batcher's worker owns dispatch;
            # pre-build the cache with the one-shot CLI instead
            first_done[0] = True
            print("aot: server-side --aot-cache dump is disabled with "
                  "--micro-batch; pre-build the cache with a one-shot run",
                  file=sys.stderr)

        def run(payload):
            # the batcher serializes device work itself; no lock
            return _run_request(batched, payload)
    else:
        def run(payload):
            with lock:  # serialize like the reference's demo.queue()
                out = _run_request(pipe, payload)
                _first_hook_locked()
                return out

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, "application/json",
                           json.dumps({"status": "ok"}).encode())
            else:
                self._send(200, "text/html", _HTML.encode())

        def do_POST(self):
            if self.path != "/inpaint":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                ctype, body = run(payload)
                self._send(200, ctype, body)
            except KeyError as e:
                self._send(400, "application/json", json.dumps(
                    {"error": f"missing field {e}"}).encode())
            except Exception as e:  # input errors -> 400, not a crash
                self._send(400, "application/json", json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode())

    server = _Server(("0.0.0.0", port), Handler)
    server.batcher = batcher
    return server


def launch(args) -> int:
    from powerpaint_tpu_torch.serve.cli import build_pipeline, load_aot

    pipe = build_pipeline(args)
    aot = getattr(args, "aot_cache", None)
    # serving cold start: the first request builds no kernel
    aot_loaded = load_aot(pipe, aot)
    try:
        import gradio  # noqa: F401

        return _launch_gradio(pipe, args)
    except ImportError:
        pass
    micro = getattr(args, "micro_batch", 0)
    on_first = None
    if aot and not aot_loaded:
        # --aot-cache promises "else dump it there after the first call"
        def on_first():
            pipe.aot_dump(aot)
            print(f"aot: dumped {aot}", flush=True)
    server = make_server(pipe, args.port, micro_batch=micro,
                         on_first_success=on_first)
    print(f"serving on http://0.0.0.0:{args.port} (POST /inpaint, "
          f"micro_batch={micro})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def _launch_gradio(pipe, args) -> int:
    """Gradio Blocks UI mirroring the reference's four task tabs, v1
    ControlNet sub-UI, outpaint expansion sliders, advanced accordion, and
    result + mask galleries (reference app.py:563-749). Only reached when
    gradio is installed."""
    import gradio as gr
    import numpy as np

    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.tasks import preprocess
    from powerpaint_tpu_torch.tasks.postprocess import blend_result, red_overlay

    # the v1 ControlNet sub-UI: the JAX package probes ``_generate_cn``
    control = isinstance(pipe, ControlNetPipeline)

    def infer(image, mask, task, prompt, negative_prompt, fitting,
              h_expand, v_expand, enable_control, control_type,
              control_scale, control_image, steps, scale, seed):
        img = preprocess.to_numpy_image(np.asarray(image))
        short = 512 if task == "image-outpainting" else 640
        img = preprocess.resize_short_side(img, short)
        if task == "image-outpainting":
            img, m = preprocess.outpaint_canvas(img, float(h_expand),
                                                float(v_expand))
        else:
            m = preprocess.to_numpy_mask(np.asarray(mask))
            if m.shape[:2] != img.shape[:2]:
                from PIL import Image as _I

                m = np.asarray(
                    _I.fromarray((m * 255).astype(np.uint8)).resize(
                        (img.shape[1], img.shape[0])
                    )
                ).astype(np.float32) / 255.0
        img = preprocess.crop_to_multiple_of_8(img)
        m = m[: img.shape[0], : img.shape[1]]

        kwargs = dict(
            prompt=prompt, negative_prompt=negative_prompt, task=task,
            fitting_degree=float(fitting), num_inference_steps=int(steps),
            guidance_scale=float(scale), seed=int(seed),
        )
        if enable_control and control_image is not None and control:
            from powerpaint_tpu_torch.tasks.control import get_control_image

            ctrl = get_control_image(control_type, img)
            kwargs["control_image"] = ctrl
            kwargs["controlnet_conditioning_scale"] = float(control_scale)
            del kwargs["fitting_degree"]  # reference passes tradoff=1.0
        out = pipe(img, m, **kwargs)
        result = np.asarray(blend_result(out[0], img, m))
        return [result, out[0]], [red_overlay(img, m),
                                  (m * 255).astype(np.uint8)]

    with gr.Blocks() as demo:
        gr.Markdown(
            "<div align='center'><font size='6'>PowerPaint: "
            "High-Quality Versatile Image Inpainting</font></div>"
        )
        with gr.Row():
            with gr.Column():
                gr.Markdown("### Input image and mask")
                image = gr.Image(label="image")
                mask = gr.Image(label="mask (white = repaint)")
                task = gr.Radio(
                    ["text-guided", "object-removal", "shape-guided",
                     "image-outpainting"],
                    value="text-guided", visible=False, show_label=False,
                )
                prompt = gr.Textbox(label="Prompt")
                negative = gr.Textbox(label="negative_prompt")
                fitting = gr.Slider(0.0, 1.0, value=1.0, step=0.05,
                                    label="fitting degree", visible=False)
                h_expand = gr.Slider(1.0, 4.0, value=1.0, step=0.05,
                                     label="horizontal expansion ratio",
                                     visible=False)
                v_expand = gr.Slider(1.0, 4.0, value=1.0, step=0.05,
                                     label="vertical expansion ratio",
                                     visible=False)
                enable_control = gr.Checkbox(
                    label="Enable controlnet", visible=False)
                control_type = gr.Radio(
                    ["canny", "pose", "depth", "hed"], value="canny",
                    label="Control type", visible=False)
                control_scale = gr.Slider(
                    0.0, 1.0, value=0.5, step=0.05,
                    label="controlnet conditioning scale", visible=False)
                control_image = gr.Image(label="control image",
                                         visible=False)

                with gr.Tab("Text-guided object inpainting") as tab_text:
                    gr.Checkbox(label="Enable text-guided object inpainting",
                                value=True, interactive=False)
                    if control:
                        gr.Markdown("### Controlnet setting (v1 only)")
                with gr.Tab("Object removal inpainting") as tab_removal:
                    gr.Checkbox(
                        label="Enable object removal inpainting", value=True,
                        interactive=False,
                        info="Guidance Scale >= 10 recommended",
                    )
                with gr.Tab("Image outpainting") as tab_outpaint:
                    gr.Checkbox(
                        label="Enable image outpainting", value=True,
                        interactive=False,
                        info="Guidance Scale >= 10 recommended",
                    )
                with gr.Tab("Shape-guided object inpainting") as tab_shape:
                    gr.Checkbox(label="Enable shape-guided object inpainting",
                                value=True, interactive=False)

                def _sel(name, **vis):
                    def fn():
                        return [
                            name,
                            gr.update(visible=vis.get("fitting", False)),
                            gr.update(visible=vis.get("expand", False)),
                            gr.update(visible=vis.get("expand", False)),
                            gr.update(visible=vis.get("control", False)),
                            gr.update(visible=vis.get("control", False)),
                            gr.update(visible=vis.get("control", False)),
                            gr.update(visible=vis.get("control", False)),
                        ]
                    return fn

                vis_targets = [task, fitting, h_expand, v_expand,
                               enable_control, control_type, control_scale,
                               control_image]
                tab_text.select(_sel("text-guided", control=control), None,
                                vis_targets)
                tab_removal.select(_sel("object-removal"), None, vis_targets)
                tab_outpaint.select(_sel("image-outpainting", expand=True),
                                    None, vis_targets)
                tab_shape.select(_sel("shape-guided", fitting=True),
                                 None, vis_targets)

                btn = gr.Button("Run")
                with gr.Accordion("Advanced options", open=False):
                    steps = gr.Slider(1, 50, value=45, step=1, label="Steps")
                    scale = gr.Slider(
                        0.1, 30.0, value=7.5, step=0.1,
                        label="Guidance Scale",
                        info="For object removal and image outpainting, "
                             ">= 10 is recommended",
                    )
                    seed = gr.Slider(0, 2147483647, value=0, step=1,
                                     label="Seed", randomize=True)
            with gr.Column():
                gr.Markdown("### Inpainting result")
                results = gr.Gallery(label="Generated images",
                                     show_label=False, columns=2)
                gr.Markdown("### Mask")
                masks_out = gr.Gallery(label="Generated masks",
                                       show_label=False, columns=2)
        btn.click(
            infer,
            [image, mask, task, prompt, negative, fitting, h_expand,
             v_expand, enable_control, control_type, control_scale,
             control_image, steps, scale, seed],
            [results, masks_out],
        )
    demo.queue().launch(server_name="0.0.0.0", server_port=args.port,
                        share=args.share)
    return 0
