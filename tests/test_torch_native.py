"""The port's host natives (``powerpaint_tpu_torch/tasks/native.py``,
``text/native.py``), built by ``ops._build.load_native`` from the
repository's ``native/*.cpp`` into the port's ``_build/``, against the JAX
package's libraries and the Python oracles.

- The native BPE's ids equal the port's Python BPE's and the JAX package's
  ``NativeBPETokenizer``'s on ``tests/test_native.py``'s vocabulary.
- ``blend_result`` and ``red_overlay`` are bitwise the JAX package's
  native; ``gaussian_blur`` within 2 float32 ulps of 1 of it. The port
  builds with ``native/build.sh``'s flags (``-march=native``) on the host
  it runs on, while the JAX package's library is committed, built for
  another target: where the two targets differ, the blur's sums of
  products can round differently in the last bit (ROADMAP Queue C). The
  blend's uint8 result is the same on these inputs.
- Nothing under ``powerpaint_tpu/`` is opened or loaded by the port.
- Two processes building at once leave one working library.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from powerpaint_tpu.tasks import native as jax_img
from powerpaint_tpu.text import native as jax_bpe
from powerpaint_tpu_torch.ops import _build
from powerpaint_tpu_torch.tasks import native, postprocess
from powerpaint_tpu_torch.text import native as bpe
from powerpaint_tpu_torch.text.tokenizer import ClipBPETokenizer
from test_native import _synthetic_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world", "Hello  CAT", "a b c hello", "cat cat cat",
         "abc, hello! world.", "", "worldworld hellocat"]
BLUR_ULPS = 2


def test_native_bpe_ids_match(tmp_path):
    d = _synthetic_vocab(tmp_path)
    port = bpe.NativeBPETokenizer.from_dir(d)
    python = ClipBPETokenizer.from_dir(d)
    theirs = (jax_bpe.NativeBPETokenizer.from_dir(d)
              if jax_bpe.native_available() else None)
    for text in TEXTS:
        ids = port.encode_text(text)
        assert ids == python.encode_text(text), text
        if theirs is not None:
            assert ids == theirs.encode_text(text), text
    assert port.vocab_size == python.vocab_size
    assert port.decode_ids(port.encode_text("hello cat")) == "hello cat"


def _inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    result = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    original = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.float32)
    mask[h // 5:3 * h // 4, w // 7:2 * w // 3] = 1.0
    return result, original, mask


needs_jax_native = pytest.mark.skipif(
    not jax_img.native_available(),
    reason="the JAX package's native image library is not built")


@needs_jax_native
@pytest.mark.parametrize("hw,radius", [((96, 80), 4.0), ((200, 152), 4.0),
                                       ((64, 48), 1.5), ((768, 512), 4.0)],
                         ids=str)
def test_image_ops_match_jax_native(hw, radius):
    result, original, mask = _inputs(*hw, seed=hw[0])
    soft = np.random.RandomState(1).rand(*hw).astype(np.float32)
    for m in (mask, soft):
        np.testing.assert_allclose(native.gaussian_blur(m, radius),
                                   jax_img.gaussian_blur(m, radius), rtol=0,
                                   atol=BLUR_ULPS * np.spacing(np.float32(1)))
    np.testing.assert_array_equal(
        native.blend_result(result, original, mask, radius),
        jax_img.blend_result(result, original, mask, radius))
    for alpha in (0.5, 0.4):
        np.testing.assert_array_equal(native.red_overlay(original, soft, alpha),
                                      jax_img.red_overlay(original, soft, alpha))


def test_blend_is_the_native_and_the_plain_version_is_numpy():
    """``postprocess.blend_result`` is the native; ``blend_result_plain``
    (numpy, truncating) is within one uint8 level of it, and equal where
    the blurred mask is 0 or 1."""
    result, original, mask = _inputs(96, 80, seed=3)
    got = postprocess.blend_result(result, original, mask)
    np.testing.assert_array_equal(got, native.blend_result(result, original,
                                                           mask))
    plain = postprocess.blend_result_plain(result, original, mask)
    assert np.abs(got.astype(np.int32) - plain).max() <= 1
    np.testing.assert_array_equal(got[0, 0], original[0, 0])
    np.testing.assert_array_equal(got[48, 40], result[48, 40])


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True, env=env,
                          timeout=300)


def test_the_port_opens_nothing_of_the_jax_package():
    """An audit hook records every file the port opens and every library
    it loads while it builds and calls both natives: none lies under
    ``powerpaint_tpu/``."""
    out = _run("""
        import sys
        paths = []
        def hook(event, args):
            if event in ("open", "ctypes.dlopen") and args and args[0]:
                paths.append(str(args[0]))
        sys.addaudithook(hook)
        import numpy as np
        from powerpaint_tpu_torch.tasks import native
        from powerpaint_tpu_torch.text import native as bpe
        m = np.zeros((16, 16), np.float32); m[4:12, 4:12] = 1
        img = np.zeros((16, 16, 3), np.uint8)
        native.blend_result(img, img, m); native.red_overlay(img, m)
        bpe.NativeBPETokenizer({"a": 0, "a</w>": 1}, []).encode_text("a")
        print("LOADED", [p for p in paths if "ppt_" in p])
        print("JAX", [p for p in paths if "powerpaint_tpu/" in p
                      or "powerpaint_tpu" + chr(92) in p])
    """)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    loaded = eval(lines["LOADED"])  # noqa: S307 - our own printed list
    assert any("powerpaint_tpu_torch" in p and "libppt_image" in p
               for p in loaded)
    assert any("powerpaint_tpu_torch" in p and "libppt_bpe" in p
               for p in loaded)
    assert eval(lines["JAX"]) == []  # noqa: S307


def test_two_builds_at_once_leave_one_library(tmp_path):
    """Two processes build the image library into an empty directory at
    the same moment; one library is left, no temporary file, and it
    works."""
    code = f"""
        import numpy as np
        from pathlib import Path
        from powerpaint_tpu_torch.ops import _build
        _build.BUILD_DIR = Path({str(tmp_path)!r})
        from powerpaint_tpu_torch.tasks import native
        m = np.zeros((8, 8), np.float32); m[2:6, 2:6] = 1
        print(float(native.gaussian_blur(m, 1.0).sum()))
    """
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert outs[0][0] == outs[1][0]
    files = sorted(os.listdir(tmp_path))
    assert files == [_build.native_library_path("image").name], files


def test_a_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises with g++'s
    output, and nothing is left behind."""
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "image_ops.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE", tmp_path / "native")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for "
                           "native/image_ops.cpp.*error: "):
            _build.load_native("image")
    finally:
        _build.load_native.cache_clear()
    assert os.listdir(tmp_path / "build") == []
