"""The port's serving layer on the CPU: ``serve.app`` (``_run_request``, the
HTTP server, the gradio UI), ``pipelines.async_dispatch`` (``submit``) and
``io.aot`` (the cold-start cache of the built kernels).

Parity with the JAX package's serving layer runs both packages' code on
the same recording stub pipeline, a plain callable that returns a
deterministic image of its inputs: no JAX pipeline is compiled. The port's
own pipelines run at the tiny configurations in fp32.

pytest-timeout is not installed, so every socket, ``urlopen``, wait and
join carries its own timeout, and every server is shut down in
``finally``."""

import base64
import io
import json
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from powerpaint_tpu.pipelines import async_dispatch as jax_async
from powerpaint_tpu.serve import app as jax_app
from powerpaint_tpu_torch.io import aot
from powerpaint_tpu_torch.ops import _build
from powerpaint_tpu_torch.pipelines import async_dispatch
from powerpaint_tpu_torch.serve import app

WAIT = 60.0  # seconds any one request, wait or join may take


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the recording stub and the payloads
# ---------------------------------------------------------------------------


class RecStub:
    """Records what it is handed; returns, per image, a deterministic
    uint8 image of the canvas, the seed and the prompt."""

    def __init__(self):
        self.calls = []

    def __call__(self, image, mask, **kw):
        self.calls.append((np.array(image), np.array(mask), kw))
        n = kw.get("num_images_per_prompt", 1)
        base = np.asarray(image, np.int64)
        return np.stack([((base + 31 * (kw["seed"] + i) + len(kw["prompt"]))
                          % 256).astype(np.uint8) for i in range(n)])


def _b64_png(array) -> str:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _png(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def _inputs(h=70, w=90, seed=0):
    rng = np.random.RandomState(seed)
    image = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = 255
    return image, mask


def _payload(**kw):
    image, mask = _inputs()
    return dict(dict(image_b64=_b64_png(image), mask_b64=_b64_png(mask),
                     prompt="a dog", steps=3, seed=1, short_side=64), **kw)


EXTRAS = dict(scheduler="euler_a", strength=0.6, eta=0.0, clip_skip=1,
              ip_adapter_scale=0.5, guess_mode=True,
              controlnet_conditioning_scale=0.8,
              brushnet_conditioning_scale=0.9, control_guidance_start=0.1,
              control_guidance_end=0.9, encoder_cache_interval=2,
              branch_cache_interval=3)

PAYLOADS = {
    "text-guided": {},
    "object-removal": dict(task="object-removal"),
    "shape-guided": dict(task="shape-guided", fitting_degree=0.5),
    "outpainting": dict(task="image-outpainting", horizontal_expansion=1.5,
                        vertical_expansion=1.25),
    "height-width": dict(height=48, width=80),
    "no-bucket": dict(bucket=False),
    "gallery": dict(num_images=2, negative_prompt="blurry",
                    guidance_scale=9.0),
    "canny": dict(control_image_b64=_b64_png(_inputs(40, 50, 3)[0]),
                  control_type="canny"),
    "extras": dict(EXTRAS, ip_adapter_image_b64=_b64_png(_inputs(32, 32, 4)[0])),
    "mask-other-size": dict(mask_b64=_b64_png(_inputs(35, 45)[1])),
}


def _equal(a, b) -> bool:
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _decoded(ctype: str, body: bytes):
    if ctype == "image/png":
        return [_png(body)]
    return [_png(base64.b64decode(s)) for s in json.loads(body)["images"]]


@pytest.mark.parametrize("name", PAYLOADS)
def test_run_request_matches_jax(name):
    """The same payload through both packages' ``_run_request``: the stub
    sees the same image, mask and keyword arguments, and the decoded
    responses are equal."""
    payload = _payload(**PAYLOADS[name])
    got_stub, want_stub = RecStub(), RecStub()
    ctype, body = app._run_request(got_stub, payload)
    want_ctype, want_body = jax_app._run_request(want_stub, payload)
    assert ctype == want_ctype
    assert ctype == ("application/json" if name == "gallery" else "image/png")
    (gi, gm, gk), = got_stub.calls
    (wi, wm, wk), = want_stub.calls
    assert _equal(gi, wi) and _equal(gm, wm)
    assert gk.keys() == wk.keys()
    for k in gk:
        assert _equal(gk[k], wk[k]), k
    got, want = _decoded(ctype, body), _decoded(want_ctype, want_body)
    assert len(got) == len(want) == PAYLOADS[name].get("num_images", 1)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_run_request_missing_field_raises_as_jax():
    payload = _payload()
    del payload["image_b64"]
    with pytest.raises(KeyError):
        app._run_request(RecStub(), payload)
    with pytest.raises(KeyError):
        jax_app._run_request(RecStub(), payload)


# ---------------------------------------------------------------------------
# the gradio UI under a fake gradio module
# ---------------------------------------------------------------------------


class _Component:
    """Records constructor kwargs and event registrations."""

    def __init__(self, *a, **kw):
        self.args = a
        self.kw = kw
        self.events = []  # (kind, fn, inputs, outputs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def select(self, fn, inputs=None, outputs=None):
        self.events.append(("select", fn, inputs, outputs))

    def click(self, fn, inputs=None, outputs=None):
        self.events.append(("click", fn, inputs, outputs))

    def queue(self):
        return self

    def launch(self, **kw):
        self.launched = kw


def _fake_gradio():
    g = types.ModuleType("gradio")
    g.components = []

    def mk(name):
        def ctor(*a, **kw):
            c = _Component(*a, **kw)
            c.kind = name
            g.components.append(c)
            return c

        return ctor

    for name in ("Blocks", "Markdown", "Row", "Column", "Image", "Radio",
                 "Textbox", "Slider", "Checkbox", "Tab", "Button",
                 "Accordion", "Gallery"):
        setattr(g, name, mk(name))
    g.update = lambda **kw: dict(kw)
    return g


def _stubs(control: bool):
    """(port stub, JAX stub): a ControlNet pipeline to each package's test
    when ``control``."""
    if not control:
        return RecStub(), RecStub()
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline

    class PortCN(ControlNetPipeline):
        def __init__(self):
            self.calls = []

        __call__ = RecStub.__call__

    jax_cn = RecStub()
    jax_cn._generate_cn = None  # what the JAX UI probes
    return PortCN(), jax_cn


def _launch(monkeypatch, launcher, pipe):
    fake = _fake_gradio()
    monkeypatch.setitem(sys.modules, "gradio", fake)
    args = types.SimpleNamespace(port=7861, share=False)
    assert launcher(pipe, args) == 0
    return fake


def _graph(fake):
    """The components in order; the title names the package."""
    return [(c.kind, tuple(a.replace("PowerPaint-TPU:", "PowerPaint:")
                           if isinstance(a, str) else a for a in c.args), c.kw)
            for c in fake.components]


@pytest.mark.parametrize("control", [True, False], ids=["controlnet", "plain"])
def test_gradio_ui_matches_jax(monkeypatch, control):
    """The same component graph, the same tab updates, and the same
    ``infer`` calls and outputs on the stub in both packages."""
    from powerpaint_tpu.tasks import preprocess as jax_pre
    from powerpaint_tpu_torch.tasks import preprocess

    # the UI's 640/512 short sides, shrunk for the CPU as in
    # tests/test_gradio_ui.py
    for pre in (preprocess, jax_pre):
        monkeypatch.setattr(pre, "resize_short_side",
                            lambda img, short, pre=pre:
                            pre.crop_to_multiple_of_8(img))
    port_stub, jax_stub = _stubs(control)
    got = _launch(monkeypatch, app._launch_gradio, port_stub)
    want = _launch(monkeypatch, jax_app._launch_gradio, jax_stub)
    assert _graph(got) == _graph(want)

    def handlers(fake):
        tabs = [c for c in fake.components if c.kind == "Tab"]
        btn = [c for c in fake.components if c.kind == "Button"][0]
        return {t.args[0]: t.events[0][1] for t in tabs}, btn.events[0][1]

    (got_sel, got_infer), (want_sel, want_infer) = handlers(got), handlers(want)
    assert got_sel.keys() == want_sel.keys() and len(got_sel) == 4
    for tab in got_sel:
        assert got_sel[tab]() == want_sel[tab]()
    assert got_sel["Text-guided object inpainting"]()[4] == {"visible": control}

    image, mask = _inputs(64, 64, 1)
    for args in (
            (image, mask, "text-guided", "a dog", "", 1.0, 1.0, 1.0,
             False, "canny", 0.5, None, 2, 7.5, 3),
            (image, None, "image-outpainting", "a dog", "", 1.0, 1.5, 1.5,
             False, "canny", 0.5, None, 2, 7.5, 3),
            (image, mask, "shape-guided", "a cat", "blurry", 0.4, 1.0, 1.0,
             True, "canny", 0.7, image, 4, 9.0, 5)):
        g_res, g_masks = got_infer(*args)
        w_res, w_masks = want_infer(*args)
        for g, w in zip(g_res + g_masks, w_res + w_masks):
            assert np.array_equal(g, w)
    assert len(port_stub.calls) == len(jax_stub.calls) == 3
    for (gi, gm, gk), (wi, wm, wk) in zip(port_stub.calls, jax_stub.calls):
        assert _equal(gi, wi) and _equal(gm, wm) and gk.keys() == wk.keys()
        for k in gk:
            assert _equal(gk[k], wk[k]), k
    assert ("control_image" in port_stub.calls[2][2]) == control


# ---------------------------------------------------------------------------
# the tiny pipelines: submit() and the HTTP server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """The three tiny pipelines of the port, random weights, fp32, CPU."""
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.testing import (
        tiny_v1_config,
        tiny_v1_controlnet_config,
        tiny_v2_config,
    )
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    out = {}
    for name, cls, cfg in (("v1", InpaintPipeline, tiny_v1_config()),
                           ("v2", BrushNetPipeline, tiny_v2_config()),
                           ("cn", ControlNetPipeline, tiny_v1_controlnet_config())):
        state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        out[name] = cls(cfg, state, tok, dtype=torch.float32, device="cpu")
    return out


@pytest.mark.parametrize("name", ["v1", "v2", "cn"])
def test_submit_is_the_call_bitwise(tiny, name):
    """``submit(...).result()`` is bitwise ``__call__``'s image, for one
    request and for a two-request batch; on the CPU it is done at once,
    and the telemetry stage ``generate`` is recorded."""
    from powerpaint_tpu_torch.core.metrics import GLOBAL

    pipe = tiny[name]
    image, mask = _inputs(64, 64, 2)
    kw = dict(prompt="a dog", num_inference_steps=3, seed=4)
    if name == "cn":
        kw["control_image"] = _inputs(64, 64, 5)[0]
    for call_kw in (kw, dict(kw, prompt=["a dog", "a cat"], seed=[4, 9],
                             **({"control_image": [kw["control_image"]] * 2}
                                if name == "cn" else {}))):
        want = pipe(image, mask, **call_kw)
        pending = pipe.submit(image, mask, **call_kw)
        assert isinstance(pending, async_dispatch.PendingImages)
        assert pending.done()
        got = pending.result()
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want)
        assert pending.result() is got
        assert GLOBAL.last_call_report().keys() == {"generate"}


def test_submit_refuses_a_callback_as_jax(tiny):
    from powerpaint_tpu.core.validation import (
        InputValidationError as JaxInputValidationError,
    )
    from powerpaint_tpu_torch.core.validation import InputValidationError

    with pytest.raises(JaxInputValidationError) as want:
        jax_async.AsyncDispatchMixin.submit(object(), callback=print)
    image, mask = _inputs(64, 64, 2)
    with pytest.raises(InputValidationError) as got:
        tiny["v1"].submit(image, mask, callback=print)
    assert str(got.value) == str(want.value)


class _Serving:
    """A server on a free localhost port, serving in a thread."""

    def __init__(self, server):
        self.server = server
        self.url = f"http://127.0.0.1:{server.server_address[1]}"
        self.thread = threading.Thread(target=server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(WAIT)
        assert not self.thread.is_alive()

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=WAIT) as r:
            return r.status, r.headers["Content-Type"], r.read()

    def post(self, payload, path="/inpaint"):
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=WAIT) as r:
                return r.status, r.headers["Content-Type"], r.read()
        except urllib.error.HTTPError as e:
            try:
                return e.code, e.headers["Content-Type"], e.read()
            finally:
                e.close()


def test_http_server(tiny):
    """/health, the form, a 200 PNG bitwise the request run directly, the
    gallery, 400s for a bad field and a missing one, 404, and the
    first-success hook once, after the first request that succeeds."""
    pipe = tiny["v1"]
    hooks = []
    with _Serving(app.make_server(pipe, port=0,
                                  on_first_success=lambda: hooks.append(1))) as s:
        assert s.get("/health") == (200, "application/json",
                                    json.dumps({"status": "ok"}).encode())
        status, ctype, body = s.get("/")
        assert status == 200 and ctype == "text/html" and b"/inpaint" in body
        bad = s.post(_payload(task="bogus"))
        assert bad[0] == 400 and bad[1] == "application/json"
        assert "InputValidationError" in json.loads(bad[2])["error"]
        missing = _payload()
        del missing["mask_b64"]
        assert json.loads(s.post(missing)[2]) == {
            "error": "missing field 'mask_b64'"}
        assert hooks == []
        status, ctype, body = s.post(_payload())
        assert (status, ctype) == (200, "image/png")
        assert np.array_equal(_png(body),
                              _png(app._run_request(pipe, _payload())[1]))
        status, ctype, body = s.post(_payload(num_images=2))
        assert (status, ctype) == (200, "application/json")
        images = json.loads(body)["images"]
        assert len(images) == 2 and not np.array_equal(
            _png(base64.b64decode(images[0])), _png(base64.b64decode(images[1])))
        assert s.post(_payload(), path="/other")[0] == 404
        assert hooks == [1]


def test_micro_batched_server(tiny):
    """Four concurrent posts to a micro-batched server: each image within
    1 uint8 level of its request alone, every request dispatched once; a
    gallery request runs directly under the batcher's lock."""
    pipe = tiny["v1"]
    payloads = [_payload(seed=s, prompt=p) for s, p in
                ((1, "a dog"), (2, "a cat"), (3, "a red bench"), (4, ""))]
    alone = [_png(app._run_request(pipe, p)[1]).astype(np.int32)
             for p in payloads]
    results = [None] * len(payloads)
    with _Serving(app.make_server(pipe, port=0, micro_batch=4)) as s:
        def client(i):
            results[i] = s.post(payloads[i])

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        batcher = s.server.batcher
        assert sum(n * k for n, k in batcher.sizes.items()) == len(payloads)
        status, ctype, body = s.post(_payload(num_images=2))
        assert (status, ctype) == (200, "application/json")
    for (status, ctype, body), want in zip(results, alone):
        assert (status, ctype) == (200, "image/png")
        assert np.abs(_png(body).astype(np.int32) - want).max() <= 1
    assert not batcher._thread.is_alive()


# ---------------------------------------------------------------------------
# the cold-start cache
# ---------------------------------------------------------------------------


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A temporary ``_build/`` holding fake libraries for two CUDA sources
    and the image native, under their current hashed names."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    paths = [_build.library_path("flash_attention"),
             _build.library_path("conv3x3"),
             _build.native_library_path("image")]
    _build.BUILD_DIR.mkdir()
    for i, p in enumerate(paths):
        p.write_bytes(bytes([i + 1]) * (100 + 37 * i) + p.name.encode())
    return {p.name: p.read_bytes() for p in paths}


def _rewrite(path, out, edit=None, payload_cut=0):
    """Copy the cache file ``path`` to ``out`` with its header edited by
    ``edit(header)`` and ``payload_cut`` bytes dropped from its end."""
    header = aot.read_header(path)
    raw = open(path, "rb").read()
    hlen = int.from_bytes(raw[len(aot._MAGIC_LINE):len(aot._MAGIC_LINE) + 8],
                          "little")
    payload = raw[len(aot._MAGIC_LINE) + 8 + hlen:]
    if edit is not None:
        edit(header)
    text = json.dumps(header).encode()
    with open(out, "wb") as f:
        f.write(aot._MAGIC_LINE + len(text).to_bytes(8, "little") + text
                + payload[:len(payload) - payload_cut])


def _empty(build):
    for p in _build.BUILD_DIR.iterdir():
        p.unlink()
    assert not list(_build.BUILD_DIR.iterdir())


def test_cache_round_trip(build_dir, tmp_path):
    path = str(tmp_path / "kernels.aot")
    names = aot.dump(path, "cpu", "int8=0")
    assert sorted(names) == sorted(build_dir)
    header = aot.read_header(path)
    assert header["device"] == "cpu" and header["capability"] is None
    assert header["torch"] == torch.__version__ and header["mode"] == "int8=0"
    assert {lib["key"] for lib in header["libraries"]} == {
        "cuda:flash_attention", "cuda:conv3x3", "native:image"}
    _empty(build_dir)
    assert sorted(aot.load(path, "cpu", "int8=0")) == sorted(build_dir)
    assert {p.name: p.read_bytes() for p in _build.BUILD_DIR.iterdir()} == build_dir
    assert set(_build.built_libraries()) == {
        "cuda:flash_attention", "cuda:conv3x3", "native:image"}


REFUSALS = {
    "torch": lambda h: h.update(torch="0.0.1"),
    "cuda": lambda h: h.update(cuda="11.0"),
    "device": lambda h: h.update(device="NVIDIA A100-SXM4-80GB"),
    "capability": lambda h: h.update(capability="8.0"),
    "mode": lambda h: h.update(mode="int8=1"),
    "stale": lambda h: h["libraries"][0].update(
        file=h["libraries"][0]["file"][:-15] + "000000000000.so"),
    "unknown": lambda h: h["libraries"][0].update(key="cuda:nonexistent"),
    "length": None,
}


@pytest.mark.parametrize("field", REFUSALS)
def test_cache_refuses_a_mismatch_before_writing(build_dir, tmp_path, field):
    """Each header field that names another machine, mode or source, and a
    payload shorter than the header says, is refused naming the field, and
    nothing is written into ``_build/``."""
    path, bad = str(tmp_path / "kernels.aot"), str(tmp_path / "bad.aot")
    aot.dump(path, "cpu", "int8=0")
    _empty(build_dir)
    _rewrite(path, bad, REFUSALS[field], payload_cut=5 if field == "length" else 0)
    word = {"stale": "stale", "unknown": "nonexistent",
            "length": "libraries"}.get(field, field)
    with pytest.raises(RuntimeError, match=word):
        aot.load(bad, "cpu", "int8=0")
    assert not list(_build.BUILD_DIR.iterdir())


@pytest.mark.parametrize("corrupt", ["magic", "length", "json", "header-magic"])
def test_cache_refuses_a_corrupt_header(build_dir, tmp_path, corrupt):
    path = tmp_path / "kernels.aot"
    aot.dump(str(path), "cpu", "int8=0")
    _empty(build_dir)
    raw = bytearray(path.read_bytes())
    n = len(aot._MAGIC_LINE)
    if corrupt == "magic":
        raw[:n] = b"X" * n
    elif corrupt == "length":
        raw[n:n + 8] = (0).to_bytes(8, "little")
    elif corrupt == "json":
        raw[n + 8] = ord("!")
    else:
        raw = raw.replace(aot._MAGIC.encode(), b"x" * len(aot._MAGIC))
    path.write_bytes(bytes(raw))
    with pytest.raises(RuntimeError, match="powerpaint kernel cache|corrupt"):
        aot.load(str(path), "cpu")
    assert not list(_build.BUILD_DIR.iterdir())


class _Pipe(aot.AotPipelineMixin):
    device = torch.device("cpu")

    def __init__(self, int8=False):
        self.int8_x_scale = 8.0 / 127.0 if int8 else None


def test_pipeline_dump_and_load(build_dir, tmp_path, monkeypatch):
    """``aot_dump`` raises before a first call, dumps and validates after
    it; a file that does not read back byte for byte is deleted; an int8
    pipeline refuses a bf16 pipeline's file."""
    path = str(tmp_path / "kernels.aot")
    pipe = _Pipe()
    with pytest.raises(RuntimeError, match="call the pipeline once"):
        pipe.aot_dump(path)
    pipe._calls = 1
    assert sorted(pipe.aot_dump(path)) == sorted(build_dir)
    _empty(build_dir)
    assert sorted(_Pipe().aot_load(path)) == sorted(build_dir)
    with pytest.raises(RuntimeError, match="mode"):
        _Pipe(int8=True).aot_load(path)
    good = aot.read
    monkeypatch.setattr(aot, "read", lambda p: {
        k: v[:-1] for k, v in good(p).items()})
    with pytest.raises(RuntimeError, match="validation failed"):
        pipe.aot_dump(path)
    assert not (tmp_path / "kernels.aot").exists()
