"""The port's micro-batcher (``powerpaint_tpu_torch.serve.batcher``) against
the JAX package's (``powerpaint_tpu.serve.batcher``) on the same recording
stub pipeline: the same batches, the same calls and results, with and
without a ``submit`` surface; errors reach every waiter from dispatch and
from fetch; ``close`` ends both threads. No pipeline is compiled: the stub
is a plain callable returning a deterministic image of its inputs.

pytest-timeout is not installed, so every wait and join carries its own
timeout."""

import queue
import threading
import time

import numpy as np
import pytest

from powerpaint_tpu.serve import batcher as jax_batcher
from powerpaint_tpu_torch.serve import batcher

WAIT = 30.0  # seconds any one wait may take before the test fails


def _fake_image(image, kw, i):
    """A deterministic (H, W, 3) uint8 image of one request's inputs."""
    seed, prompt = kw.get("seed", 0), kw.get("prompt", "")
    seed = seed[i] if isinstance(seed, list) else seed
    prompt = prompt[i] if isinstance(prompt, list) else prompt
    return ((np.asarray(image, np.int64) + 7 * int(seed) + len(prompt)) % 256
            ).astype(np.uint8)


class _Done:
    def __init__(self, out):
        self.out = out

    def result(self):
        return self.out


class Stub:
    """Records every call; the first blocks until ``release`` is set, so the
    queue fills while the worker is inside it."""

    def __init__(self):
        self.calls = []
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, image, mask, **kw):
        self.calls.append((image, mask, kw))
        if len(self.calls) == 1:
            self.entered.set()
            assert self.release.wait(WAIT)
        if isinstance(image, list):
            return np.stack([_fake_image(im, kw, i) for i, im in enumerate(image)])
        return _fake_image(image, kw, 0)[None]


class SubmitStub(Stub):
    """The same, with the pipelines' ``submit`` surface."""

    def submit(self, image, mask, **kw):
        return _Done(self(image, mask, **kw))


def _requests():
    """(image, mask, kwargs) of eleven requests: a first one, then a group
    of four compatible ones with one of another task among them, one with
    eta, one of another shape, and three with control images (the last a
    pair)."""
    rng = np.random.RandomState(0)
    img = lambda h, w: (rng.rand(h, w, 3) * 255).astype(np.uint8)  # noqa: E731
    small, other = img(16, 16), img(24, 16)
    mask = np.ones((16, 16), np.float32)
    edge = np.zeros((16, 16, 3), np.uint8)
    base = dict(task="text-guided", num_inference_steps=3)
    return [
        (small, mask, dict(base, prompt="first", seed=1)),
        (small, mask, dict(base, prompt="a dog", seed=2, guidance_scale=5.0)),
        (img(16, 16), mask, dict(base, prompt="a cat", seed=3,
                                 negative_prompt="blurry")),
        (small, mask, dict(task="object-removal", num_inference_steps=3,
                           prompt="x", seed=4)),
        (small, mask, dict(base, prompt="a bird", seed=5, fitting_degree=0.5)),
        (small, mask, dict(base, prompt="a fish", seed=11)),
        (small, mask, dict(base, prompt="eta", seed=6, eta=0.5)),
        (other, np.ones((24, 16), np.float32), dict(base, prompt="tall", seed=7)),
        (small, mask, dict(base, prompt="edges", seed=8, control_image=edge)),
        (small, mask, dict(base, prompt="edges 2", seed=9, control_image=edge + 1)),
        (small, mask, dict(base, prompt="pair", seed=10,
                           control_image=[edge, edge])),
    ]


def _drive(module, stub):
    """Submit the requests in a fixed order while the first call holds the
    worker; returns (calls, results, batch sizes)."""
    b = module.MicroBatcher(stub, max_batch=4, window_ms=100.0)
    reqs = _requests()
    results = [None] * len(reqs)

    def client(i):
        image, mask, kw = reqs[i]
        results[i] = b.submit(image, mask, **kw)

    threads = []
    try:
        for i in range(len(reqs)):
            t = threading.Thread(target=client, args=(i,), daemon=True)
            t.start()
            threads.append(t)
            if i == 0:
                assert stub.entered.wait(WAIT)
            else:  # each request is in the queue before the next is sent
                deadline = time.monotonic() + WAIT
                while b._q.qsize() < i:
                    assert time.monotonic() < deadline
                    time.sleep(0.001)
        stub.release.set()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
    finally:
        stub.release.set()
        b.close()
    sizes = [len(im) if isinstance(im, list) else 1 for im, _, _ in stub.calls]
    return stub.calls, results, sizes


def _equal(a, b) -> bool:
    """Equal values, arrays and (nested) lists of them alike."""
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _same_calls(got, want):
    assert len(got) == len(want)
    for (gi, gm, gk), (wi, wm, wk) in zip(got, want):
        assert _equal(gi, wi) and _equal(gm, wm)
        assert gk.keys() == wk.keys()
        for k in gk:
            assert _equal(gk[k], wk[k]), k


@pytest.mark.parametrize("stub_cls", [Stub, SubmitStub],
                         ids=["without-submit", "with-submit"])
def test_grouping_matches_jax(stub_cls):
    got_calls, got, got_sizes = _drive(batcher, stub_cls())
    want_calls, want, want_sizes = _drive(jax_batcher, stub_cls())
    assert got_sizes == want_sizes
    assert max(got_sizes) == 4  # the compatible group ran as one batch
    _same_calls(got_calls, want_calls)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # every request's image is its own, batched or alone
    for (image, _, kw), out in zip(_requests(), got):
        assert np.array_equal(out, _fake_image(image, kw, 0))


def test_the_shared_fields_match_jax():
    assert batcher.PER_REQUEST == jax_batcher.PER_REQUEST
    assert batcher.PER_REQUEST_DEFAULTS == jax_batcher.PER_REQUEST_DEFAULTS
    assert batcher.SHARED == jax_batcher.SHARED


@pytest.mark.parametrize("kw", [dict(eta=0.3), dict(ip_adapter_image=1),
                                dict(ip_adapter_image_embeds=1),
                                dict(latents=1), dict(eta=0.0)],
                         ids=["eta", "ip-image", "ip-embeds", "latents", "eta0"])
def test_batchable_and_group_key_match_jax(kw):
    image, mask = np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8), np.float32)
    full = dict(kw, task="text-guided", scheduler="euler_a",
                controlnet_conditioning_scale=[1.0, 0.5],
                control_image=[np.zeros((8, 8, 3)), np.zeros((8, 8, 3))])
    got = batcher._Pending(image=image, mask=mask, kwargs=full)
    want = jax_batcher._Pending(image=image, mask=mask, kwargs=full)
    assert got.batchable() == want.batchable()
    assert got.group_key() == want.group_key()


class _Failing(SubmitStub):
    """Raises in dispatch (``where="dispatch"``) or in the fetch."""

    def __init__(self, where):
        super().__init__()
        self.where = where
        self.release.set()

    def submit(self, image, mask, **kw):
        if self.where == "dispatch":
            raise ValueError("bad dispatch")

        class _Bad:
            def result(self):
                raise ValueError("bad fetch")
        return _Bad()


@pytest.mark.parametrize("where", ["dispatch", "fetch"])
def test_errors_reach_every_waiter(where):
    """A batch of three whose dispatch (or fetch) raises: each of the three
    submitters gets the error, and the batcher serves the next request."""
    stub = _Failing(where)
    b = batcher.MicroBatcher(stub, max_batch=3, window_ms=2000.0)
    errors, threads = queue.Queue(), []
    image, mask = np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8), np.float32)

    def client(seed):
        try:
            b.submit(image, mask, prompt="p", seed=seed)
            errors.put(None)
        except ValueError as e:
            errors.put(str(e))

    try:
        for s in range(3):
            t = threading.Thread(target=client, args=(s,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        got = sorted(errors.get(timeout=WAIT) for _ in range(3))
        assert got == [f"bad {where}"] * 3
        # a batch counts once its dispatch has returned
        assert b.sizes == ({3: 1} if where == "fetch" else {})
    finally:
        b.close()
    assert not b._thread.is_alive() and not b._fetcher.is_alive()


def test_dispatch_holds_the_lock_and_close_ends_the_threads():
    """Every dispatch runs under ``lock`` (the direct path takes it too),
    and ``close`` ends the worker and the fetcher."""
    held = []

    class Locked(SubmitStub):
        def submit(self, image, mask, **kw):
            held.append(b.lock.locked())
            return super().submit(image, mask, **kw)

    stub = Locked()
    stub.release.set()
    b = batcher.MicroBatcher(stub, max_batch=2, window_ms=1.0)
    try:
        out = b.submit(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8)),
                       prompt="p", seed=2)
        assert out.shape == (8, 8, 3) and held == [True]
        assert b.sizes == {1: 1}
    finally:
        b.close()
    assert not b._thread.is_alive() and not b._fetcher.is_alive()
