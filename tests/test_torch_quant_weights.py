"""The port's weight quantization held against ``pipegoose_tpu.quant``:
the same numpy weights, quantized by both, give the same int8 ``q`` and
float32 ``scale`` bit for bit (int8, and int4 with G = 16 and 32, float32
and bf16 weights); packing, dequantization, the byte census, the spec
errors and the TP check agree; and ``params_from_jax`` carries a JAX
quantized tree across with ``q`` still int8 and ``scale`` still float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.quant import matmul as jmatmul
from pipegoose_tpu.quant import weights as jweights
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.quant import matmul as tmatmul
from pipegoose_tpu_torch.quant import weights as tweights

KERNELS = (("attn", "qkv"), ("attn", "out"), ("mlp", "up"), ("mlp", "down"))
SPECS = {"int8": ("int8", 32), "int4_g16": ("int4", 16), "int4_g32": ("int4", 32)}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _config(dtype=torch.float32):
    return tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                              dtype=dtype)


@pytest.fixture(scope="module")
def np_tree():
    return tbloom.init_params_numpy(_config(), seed=3)


def _trees(np_tree, dtype_name):
    tdtype, jdtype = DTYPES[dtype_name]
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), np_tree)
    tparams = params_from_jax(np_tree, _config(tdtype), device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_quantize_params_equals_jax_bit_for_bit(np_tree, spec_name, dtype_name):
    jparams, tparams = _trees(np_tree, dtype_name)
    jq = jweights.quantize_params(jparams, jweights.QuantSpec(*SPECS[spec_name]))
    tq = tweights.quantize_params(tparams, tweights.QuantSpec(*SPECS[spec_name]))
    for i, blk in enumerate(tq["blocks"]):
        for a, b in KERNELS:
            leaf, jleaf = blk[a][b], jq["blocks"][a][b]
            assert leaf["q"].dtype == torch.int8 and leaf["scale"].dtype == torch.float32
            np.testing.assert_array_equal(leaf["q"].numpy(), np.asarray(jleaf["q"][i]),
                                          err_msg=f"layer {i} {a}.{b} q")
            np.testing.assert_array_equal(leaf["scale"].numpy(),
                                          np.asarray(jleaf["scale"][i]),
                                          err_msg=f"layer {i} {a}.{b} scale")
            # bias and the LayerNorms pass through as the same objects
            assert leaf["bias"] is tparams["blocks"][i][a][b]["bias"]
        assert blk["ln_1"]["scale"] is tparams["blocks"][i]["ln_1"]["scale"]
    assert tq["embed"]["weight"] is tparams["embed"]["weight"]
    assert tq["ln_f"]["bias"] is tparams["ln_f"]["bias"]


def test_int4_scales_are_per_group_and_packed_rows_halve_k(np_tree):
    _, tparams = _trees(np_tree, "f32")
    tq = tweights.quantize_params(tparams, tweights.QuantSpec("int4", 16))
    down = tq["blocks"][0]["mlp"]["down"]            # kernel (256, 64)
    assert tuple(down["q"].shape) == (128, 64)
    assert tuple(down["scale"].shape) == (256 // 16, 64)
    assert tuple(tweights.quantize_params(tparams, tweights.QuantSpec())
                 ["blocks"][0]["mlp"]["down"]["scale"].shape) == (64,)


def test_pack_and_unpack_int4_equal_jax_on_every_byte():
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    unpacked = tmatmul.unpack_int4(torch.from_numpy(every_byte))
    np.testing.assert_array_equal(unpacked.numpy(),
                                  np.asarray(jmatmul.unpack_int4(jnp.asarray(every_byte))))
    assert unpacked.dtype == torch.int8
    assert int(unpacked.min()) == -8 and int(unpacked.max()) == 7
    np.testing.assert_array_equal(tweights.pack_int4(unpacked).numpy(), every_byte)
    # every (low, high) nibble pair packs as JAX packs it
    pairs = np.stack(np.meshgrid(np.arange(-8, 8), np.arange(-8, 8)), 0)
    nibbles = pairs.reshape(2, 256).astype(np.int8)
    np.testing.assert_array_equal(
        tweights.pack_int4(torch.from_numpy(nibbles)).numpy(),
        np.asarray(jweights.pack_int4(jnp.asarray(nibbles))))


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_dequantize_params_equals_jax(np_tree, spec_name):
    jparams, tparams = _trees(np_tree, "f32")
    spec = SPECS[spec_name]
    jd = jweights.dequantize_params(jweights.quantize_params(jparams, jweights.QuantSpec(*spec)))
    td = tweights.dequantize_params(tweights.quantize_params(tparams, tweights.QuantSpec(*spec)))
    for i, blk in enumerate(td["blocks"]):
        for a, b in KERNELS:
            assert set(blk[a][b]) == {"kernel", "bias"}
            np.testing.assert_array_equal(blk[a][b]["kernel"].numpy(),
                                          np.asarray(jd["blocks"][a][b]["kernel"][i]))
    # the round trip loses at most half a quantization step per weight
    w = tparams["blocks"][1]["mlp"]["up"]["kernel"]
    leaf = tweights.quantize_params(tparams, tweights.QuantSpec(*spec))["blocks"][1]["mlp"]["up"]
    step = leaf["scale"] if spec[0] == "int8" else leaf["scale"].repeat_interleave(spec[1], 0)
    assert bool(((td["blocks"][1]["mlp"]["up"]["kernel"] - w).abs() <= 0.5 * step + 1e-7).all())


@pytest.mark.parametrize("args, match", [
    (("int2", 32), "weight_dtype"),
    (("fp8", 32), "weight_dtype"),
    (("int4", 3), "group_size"),
    (("int4", 0), "group_size"),
])
def test_quant_spec_errors_as_jax(args, match):
    with pytest.raises(ValueError, match=match):
        jweights.QuantSpec(*args)
    with pytest.raises(ValueError, match=match):
        tweights.QuantSpec(*args)


def test_group_that_does_not_divide_k_raises(np_tree):
    _, tparams = _trees(np_tree, "f32")
    with pytest.raises(ValueError, match="must divide the contraction dim"):
        tweights.quantize_params(tparams, tweights.QuantSpec("int4", 24))
    with pytest.raises(ValueError, match="even contraction dim"):
        tweights.pack_int4(torch.zeros(3, 4, dtype=torch.int8))


@pytest.mark.parametrize("tp, spec", [(1, ("int4", 32)), (2, ("int4", 32)),
                                      (4, ("int4", 32)), (4, ("int8", 32)),
                                      (3, ("int4", 16)), (2, None)])
def test_validate_tp_compat_as_jax(tp, spec):
    cfg = _config()
    spec_j = jweights.QuantSpec(*spec) if spec else None
    spec_t = tweights.QuantSpec(*spec) if spec else None
    try:
        jweights.validate_tp_compat(cfg, tp, spec_j)
        jax_raised = None
    except ValueError as e:
        jax_raised = str(e)
    if jax_raised is None:
        tweights.validate_tp_compat(cfg, tp, spec_t)
    else:
        with pytest.raises(ValueError) as err:
            tweights.validate_tp_compat(cfg, tp, spec_t)
        assert str(err.value) == jax_raised


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("spec_name", [None] + sorted(SPECS))
def test_weight_byte_census_equals_jax(np_tree, spec_name, dtype_name):
    jparams, tparams = _trees(np_tree, dtype_name)
    if spec_name is not None:
        jparams = jweights.quantize_params(jparams, jweights.QuantSpec(*SPECS[spec_name]))
        tparams = tweights.quantize_params(tparams, tweights.QuantSpec(*SPECS[spec_name]))
    want = jweights.quantized_weight_bytes(jparams)
    assert tweights.quantized_weight_bytes(tparams) == want
    assert want["total_bytes"] > 0


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_params_from_jax_keeps_quantized_leaves_exact(np_tree, spec_name, dtype_name):
    """The trap: without care every leaf goes through float32 to the
    config's dtype, and an int8 ``q`` would become a bf16 weight."""
    tdtype, _ = DTYPES[dtype_name]
    jparams, tparams = _trees(np_tree, dtype_name)
    jq = jweights.quantize_params(jparams, jweights.QuantSpec(*SPECS[spec_name]))
    host = jax.tree_util.tree_map(np.asarray, jq)
    carried = params_from_jax(host, _config(tdtype), device="cpu")
    ported = tweights.quantize_params(tparams, tweights.QuantSpec(*SPECS[spec_name]))
    for i in range(2):
        for a, b in KERNELS:
            got, want = carried["blocks"][i][a][b], ported["blocks"][i][a][b]
            assert got["q"].dtype == torch.int8
            assert got["scale"].dtype == torch.float32
            assert got["bias"].dtype == tdtype
            assert torch.equal(got["q"], want["q"])
            assert torch.equal(got["scale"], want["scale"])
        assert carried["blocks"][i]["ln_1"]["scale"].dtype == tdtype
    assert carried["embed"]["weight"].dtype == tdtype
    assert tweights.quantized_weight_bytes(carried) == tweights.quantized_weight_bytes(ported)
