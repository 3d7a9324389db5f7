"""How the port's kernels cut their work, from the pure Python mirrors of
the CUDA sources' choices (``ops.flash_attention.bf16_config``,
``ops.conv.bf16_plan``, ``ops.conv.int8_plan``, ``ops.norms.gn_plan``,
``ops.norms.ln_plan``; a card test in ``test_torch_kernels_cuda.py`` holds
each mirror to its source): every shape the main paths launch fits the
card, the VAE's D = 512 takes at most two slices and the asymmetric
decoder's D = 768 / 1024 three and four, the convs' K splits cover
K and do not depend on the batch, GroupNorm's form covers the map in shared
memory that fits, one launch at every UNet and BrushNet map at 512^2, and
LayerNorm's lanes cover each element of a row once, within the register
budget."""

import pytest

from powerpaint_tpu_torch.ops.conv import bf16_plan, int8_plan
from powerpaint_tpu_torch.ops.flash_attention import bf16_config
from powerpaint_tpu_torch.ops.norms import LN_MAX_C, gn_plan, ln_plan

SMEM_LIMIT = 232448  # bytes of shared memory one block may take on an H100


def test_flash_config_covers_every_head_dim():
    for d in range(1, 1025):
        c = bf16_config(d)
        assert c["smem"] <= SMEM_LIMIT, d
        assert c["do"] % 8 == 0 and c["bk"] % 16 == 0 and c["stages"] >= 2, d
        assert c["slices"] == (1 if d <= 256 else -(-d // 256)), d
        assert c["do"] * c["slices"] >= d, d
    for d in (0, 1025, 2048):
        with pytest.raises(ValueError):
            bf16_config(d)


@pytest.mark.parametrize("d,want", [(40, (40, 128, 2)), (80, (80, 128, 2)),
                                    (160, (160, 64, 2)), (512, (256, 32, 1)),
                                    (513, (256, 32, 1)), (768, (256, 32, 1)),
                                    (1024, (256, 16, 1))])
def test_flash_config_main_path_head_dims(d, want):
    c = bf16_config(d)
    assert (c["do"], c["bk"], c["nwg"]) == want


@pytest.mark.parametrize("d,slices,smem", [(513, 3, 230432), (768, 3, 230432),
                                           (769, 4, 214048), (1024, 4, 214048)])
def test_flash_config_past_512_fits_two_stages(d, slices, smem):
    """Past D = 512 the q tile of 64 x D grows: 32 kv rows a stage fit to
    768 (2 KB under the limit), 16 to 1024 (32 would need 295,968 bytes)."""
    c = bf16_config(d)
    assert (c["slices"], c["smem"], c["stages"]) == (slices, smem, 2)
    assert c["smem"] <= SMEM_LIMIT


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


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_int8_plan_is_batch_invariant_and_covers_k(shape):
    h, w, cin, cout = shape
    plans = [int8_plan(b, h, w, cin, cout) for b in (1, 2, 3, 4)]
    n_chunks = -(-cin // 128)
    for p in plans:
        assert (p["bn"], p["splits"], p["per"]) == \
            (plans[0]["bn"], plans[0]["splits"], plans[0]["per"])
        assert p["splits"] in (1, 2, 4, 8)  # one portable cluster of splits
        assert (p["splits"] - 1) * p["per"] < n_chunks <= p["splits"] * p["per"]
        assert 2 * p["blocks"] >= p["tiles"] and p["n_tiles"] * p["bn"] >= cout
        assert p["smem"] <= SMEM_LIMIT
        # the split sums are reduced in the slab and weight ring's memory
        assert 512 * p["bn"] <= p["smem"] - 1024


# (H, W, Cin, Cout) -> (Cout tile, K splits) on 132 SMs
@pytest.mark.parametrize("shape,want", [
    ((64, 64, 320, 320), (160, 1)), ((64, 64, 960, 320), (160, 1)),
    ((16, 16, 2560, 1280), (160, 4)), ((8, 8, 1280, 1280), (64, 4)),
    ((256, 256, 128, 256), (256, 1))], ids=str)
def test_int8_plan_main_path_shapes(shape, want):
    p = int8_plan(2, *shape)
    assert (p["bn"], p["splits"]) == want


def _maps(h, w):
    """(S, C) of every GroupNorm input of the UNet, BrushNet and VAE at an
    h x w image: the ResNet units' and transformers' maps at each latent
    level with the up-blocks' concatenated widths, the VAE's levels."""
    maps = set()
    for i, (ch, cat) in enumerate(((320, (320, 640, 960)), (640, (640, 960, 1280, 1920)),
                                   (1280, (1280, 1920, 2560)), (1280, (1280, 2560)))):
        s = (h // 8 >> i) * (w // 8 >> i)
        maps.update((s, c) for c in (ch,) + cat)
    for i, c in enumerate((128, 256, 512, 512)):
        s = (h >> i) * (w >> i)
        maps.update({(s, c), (s, 2 * c), (s, c // 2)} - {(s, 64)})
    return sorted(maps)


UNET_MAPS = [m for m in _maps(512, 512) if m[0] <= 4096]
VAE_MAPS = [m for m in _maps(512, 512) if m[0] > 4096]
RAGGED_MAPS = [(35, 20, 10), (7, 48, 24), (1, 64, 32), (5, 2560, 32), (100000, 96, 32)]


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("case", [(s, c, 32) for s, c in UNET_MAPS + VAE_MAPS]
                         + RAGGED_MAPS, ids=str)
def test_gn_plan_fits_and_covers_the_map(case, esize):
    s, c, groups = case
    p = gn_plan(s, c, groups, esize)
    gs = c // groups
    assert p["smem"] <= 200 * 1024 and p["smem2"] <= 200 * 1024
    if p["resident"]:
        assert p["span"] % gs == 0 and p["spans"] * p["span"] == c
        assert p["k"] * gs == p["span"]
        assert p["cluster"] in (1, 2, 4, 8, 16) and p["chunks"] == p["cluster"]
        assert p["rows"] == -(-s // p["cluster"])  # trailing blocks may hold none
        assert p["rows"] * p["span"] * esize <= 96 * 1024
        # whole 16-byte vectors a row where the row allows it
        assert (p["span"] * esize) % 16 == 0 or p["span"] == c
    else:
        assert p["span"] == c and p["k"] == groups and p["cluster"] == 1
        assert (p["chunks"] - 1) * p["rows"] < s <= p["chunks"] * p["rows"]
        assert 1 <= p["sub_rows"] <= p["rows"]


@pytest.mark.parametrize("esize", [2, 4])
def test_gn_plan_is_one_launch_at_every_unet_map(esize):
    """The resident form (one launch) at every UNet and BrushNet map at
    512^2; the VAE's full-size maps at 128 and 256 channels stream.
    Nothing in the plan depends on the batch: it takes none."""
    for s, c in UNET_MAPS:
        assert gn_plan(s, c, 32, esize)["resident"] == 1, (s, c)
    assert gn_plan(512 * 512, 256, 32, esize)["resident"] == 0
    assert gn_plan(512 * 512, 128, 32, esize)["resident"] == 0


# (S, C) -> (span, cluster) at bf16 on 132 SMs
@pytest.mark.parametrize("case,want", [
    ((4096, 320), (80, 16)), ((4096, 960), (120, 16)), ((1024, 640), (80, 8)),
    ((256, 1280), (80, 2)), ((64, 2560), (80, 1))], ids=str)
def test_gn_plan_main_path_shapes(case, want):
    p = gn_plan(*case, 32, 2)
    assert (p["span"], p["cluster"]) == want


# C: the main paths' (the UNet's four levels, CLIP), then odd ones up to
# the most the LayerNorm kernel takes
LN_CS = [320, 640, 1280, 768, 1, 3, 7, 77, 300, 321, 1279, 1537, 2047, LN_MAX_C]


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("c", LN_CS)
def test_ln_plan_covers_the_row_exactly(c, esize):
    """Thread t of a row's group holds elements (j * group + t) * VEC + k:
    every element of the row once, at most 3 vectors a thread and no thread
    a vector wholly past C where a warp's lanes hold the row; a group is a
    power of two up to a warp, or whole warps that make the block. The plan
    takes no row count, so no batch can change a row's reduction order."""
    vec = 16 // esize
    p = ln_plan(c, esize)
    group, vecs = p["group"], p["vecs"]
    held = sorted((j * group + t) * vec + k for t in range(group)
                  for j in range(vecs) for k in range(vec))
    assert [e for e in held if e < c] == list(range(c))
    assert 1 <= vecs <= 3 and (vecs - 1) * group * vec < c
    if group <= 32:
        assert group & (group - 1) == 0 and p["threads"] == 128
        assert p["rows"] * group == 128 and (group == 1 or 3 * group // 2 < -(-c // vec))
    else:
        assert group % 32 == 0 and p["threads"] == group <= 256 and p["rows"] == 1


# C -> (group, vecs, threads) at bf16
@pytest.mark.parametrize("c,want", [(320, (16, 3, 128)), (640, (32, 3, 128)),
                                    (1280, (64, 3, 64)), (768, (32, 3, 128))])
def test_ln_plan_main_path_rows(c, want):
    p = ln_plan(c, 2)
    assert (p["group"], p["vecs"], p["threads"]) == want
