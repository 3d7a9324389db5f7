"""How the port's bf16 kernels cut their work, from the pure Python mirrors
of the CUDA sources' choices (``ops.flash_attention.bf16_config`` and
``ops.conv.bf16_plan``; a card test in ``test_torch_kernels_cuda.py``
holds each mirror to its source): every shape the main paths launch fits
the card, the VAE's D = 512 takes at most two slices, and the conv's K
splits do not depend on the batch."""

import pytest

from powerpaint_tpu_torch.ops.conv import bf16_plan
from powerpaint_tpu_torch.ops.flash_attention import bf16_config

SMEM_LIMIT = 232448  # bytes of shared memory one block may take on an H100


def test_flash_config_covers_every_head_dim():
    for d in range(1, 513):
        c = bf16_config(d)
        assert c["smem"] <= SMEM_LIMIT, d
        assert c["do"] % 8 == 0 and c["bk"] % 16 == 0 and c["stages"] >= 2, d
        assert c["slices"] == (1 if d <= 256 else 2), d
        assert c["do"] * c["slices"] >= d, d
    for d in (0, 513, 1024):
        with pytest.raises(ValueError):
            bf16_config(d)


@pytest.mark.parametrize("d,want", [(40, (40, 128, 2)), (80, (80, 128, 2)),
                                    (160, (160, 64, 2)), (512, (256, 32, 1))])
def test_flash_config_main_path_head_dims(d, want):
    c = bf16_config(d)
    assert (c["do"], c["bk"], c["nwg"]) == want


# (H, W, Cin, Cout): the UNet's, BrushNet's and VAE's conv shapes at 512^2,
# and ragged ones
CONV_SHAPES = [(64, 64, 320, 320), (64, 64, 960, 320), (32, 32, 640, 640),
               (16, 16, 2560, 1280), (8, 8, 1280, 1280), (64, 64, 640, 640),
               (512, 512, 128, 128), (256, 256, 256, 256), (64, 64, 512, 512),
               (8, 8, 48, 40), (5, 7, 20, 12), (1, 1, 64, 64), (9, 13, 64, 200)]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_plan_is_batch_invariant_and_covers_the_work(shape):
    h, w, cin, cout = shape
    plans = [bf16_plan(b, h, w, cin, cout) for b in (1, 2, 3, 4)]
    for p in plans:
        assert (p["bn"], p["splits"], p["per"]) == \
            (plans[0]["bn"], plans[0]["splits"], plans[0]["per"])
        n_chunks = -(-cin // 64)
        assert (p["splits"] - 1) * p["per"] < n_chunks <= p["splits"] * p["per"]
        assert 2 * p["blocks"] >= p["tiles"] and p["n_tiles"] * p["bn"] >= cout
        assert p["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("cout", [320, 640, 1280, 128, 256, 512, 40, 200, 12])
def test_conv_plan_cout_tile_pads_least(cout):
    least = min(-(-cout // n) * n for n in (64, 128, 160, 256))
    for h, cin in ((64, 320), (8, 1280), (512, 128)):
        p = bf16_plan(2, h, h, cin, cout)
        assert p["bn"] in (64, 128, 160, 256) and p["n_tiles"] * p["bn"] == least


# (H, W, Cin, Cout) -> (Cout tile, K splits) at 512^2 on 132 SMs: wide tiles
# and no split at the wide levels, narrow tiles and split K at the deep ones
@pytest.mark.parametrize("shape,want", [
    ((64, 64, 320, 320), (160, 1)), ((64, 64, 640, 640), (160, 1)),
    ((16, 16, 2560, 1280), (160, 4)), ((8, 8, 1280, 1280), (64, 5)),
    ((512, 512, 128, 128), (128, 1)), ((512, 512, 256, 256), (256, 1))], ids=str)
def test_conv_plan_main_path_shapes(shape, want):
    p = bf16_plan(2, *shape)
    assert (p["bn"], p["splits"]) == want
