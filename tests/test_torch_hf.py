"""The port's HF converter (``models/convert.py``, ``models/hf.py``) held
against random-init HF models and against the JAX package's converter.

- ``from_hf`` of HF ``BloomForCausalLM``, ``LlamaForCausalLM`` (GQA,
  untied and tied) and ``MixtralForCausalLM`` (GQA, 4 experts, top-2):
  the port's ``forward`` logits against HF's at 2e-4, as
  ``tests/models/test_llama.py:52`` holds JAX's (BLOOM on the valid
  positions of a right-padded row, as ``tests/models/test_bloom.py``), and
  ``loss_fn`` against HF's loss (2e-4): the BLOOM second oracle of the
  port, beside the JAX package;
- each converted tree, through ``params_to_jax``, equal to the JAX
  ``from_hf`` tree bit for bit;
- the state-dict round trip (``state_dict_from_params`` of the converted
  tree gives back HF's tensors; BLOOM's export loads into a fresh HF model
  with the same logits);
- an ALBERT layout the port does not run (two hidden groups, another
  activation) and an unknown type raise NotImplementedError.

No weights are fetched: every HF model is a random-init config built
here, seeded with ``torch.manual_seed(0)``.
"""
import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from pipegoose_tpu.models import convert as jconvert  # noqa: E402
from pipegoose_tpu_torch.models import convert, hf  # noqa: E402
from pipegoose_tpu_torch.models import bloom, llama, mixtral  # noqa: E402
from pipegoose_tpu_torch.models.weights import params_to_jax  # noqa: E402

TOL = 2e-4
IDS = np.random.RandomState(42).randint(0, 128, (2, 10))
MASK = np.ones((2, 10), np.int64)
MASK[1, 7:] = 0


def _bloom():
    torch.manual_seed(0)
    m = transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=128, hidden_size=64, n_layer=3, n_head=4, use_cache=False))
    return m.eval()


def _llama(tied=False):
    torch.manual_seed(0)
    m = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=tied,
        use_cache=False))
    return m.eval()


def _mixtral():
    torch.manual_seed(0)
    m = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, use_cache=False))
    return m.eval()


MODELS = {"bloom": (_bloom, bloom), "llama": (_llama, llama),
          "llama_tied": (lambda: _llama(tied=True), llama), "mixtral": (_mixtral, mixtral)}


def _logits(module, params, cfg, ids, mask):
    out = module.forward(params, ids, mask, cfg)
    return (out[0] if isinstance(out, tuple) else out).numpy()


@pytest.mark.parametrize("name", list(MODELS))
def test_from_hf_matches_hf_logits_and_loss(name):
    make, want_module = MODELS[name]
    model = make()
    cfg, params, module = convert.from_hf(model, device="cpu")
    assert module is want_module
    assert params["embed"]["weight"].device.type == "cpu"
    ids = torch.from_numpy(IDS)
    padded = name == "bloom"
    mask = torch.from_numpy(MASK) if padded else None
    with torch.no_grad():
        ref = model(input_ids=ids, attention_mask=mask).logits.numpy()
        ref_loss = model(input_ids=ids, labels=ids).loss.item()
        got = _logits(module, params, cfg, ids, mask)
        loss = module.loss_fn(params, ids, None, ids, cfg).item()
    valid = MASK.astype(bool) if padded else np.ones(MASK.shape, bool)
    np.testing.assert_allclose(got[valid], ref[valid], rtol=TOL, atol=TOL)
    if name == "mixtral":   # HF adds its router aux loss only with output_router_logits
        assert model.config.output_router_logits is False
        with torch.no_grad():
            _, aux, z = mixtral.forward_hidden(params, ids, None, cfg)
        loss -= cfg.aux_loss_weight * aux.mean().item() + cfg.z_loss_weight * z.mean().item()
    assert abs(loss - ref_loss) <= TOL, (loss, ref_loss)


JAX_LOADERS = {"bloom": "bloom_params_from_hf", "llama": "llama_params_from_hf",
               "llama_tied": "llama_params_from_hf", "mixtral": "mixtral_params_from_hf"}


@pytest.mark.parametrize("name", list(MODELS))
def test_converted_tree_equals_jax_and_round_trips(name):
    from pipegoose_tpu.models import hf as jhf

    model = MODELS[name][0]()
    cfg, params, _ = convert.from_hf(model, device="cpu")
    jcfg, jparams = getattr(jhf, JAX_LOADERS[name])(model)
    for field in ("vocab_size", "hidden_size", "n_layer", "n_head"):
        assert getattr(cfg, field) == getattr(jcfg, field)
    tree = params_to_jax(params)
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert len(want) == len(got)
    for path, w in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], np.asarray(w))
    rules = {"bloom": hf.BLOOM_RULES, "mixtral": hf.MIXTRAL_RULES}.get(name, hf.LLAMA_RULES)
    prefix = "transformer." if name == "bloom" else ""
    sd = convert.state_dict_from_params(tree, rules, prefix=prefix)
    hf_sd = model.state_dict()
    assert sd.keys() <= hf_sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(v, hf_sd[k].numpy(), err_msg=k)
    assert sd.keys() == jconvert.state_dict_from_params(jparams, rules, prefix=prefix).keys()


def test_bloom_export_loads_into_hf():
    model = _bloom()
    cfg, params, _ = convert.from_hf(model, device="cpu")
    sd = hf.bloom_params_to_hf_state_dict(params)
    fresh = transformers.BloomForCausalLM(model.config).eval()
    fresh.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    ids = torch.from_numpy(IDS)
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(input_ids=ids).logits.numpy(),
                                      model(input_ids=ids).logits.numpy())


def test_albert_and_unknown_families_are_refused():
    """ALBERT is registered (``tests/test_torch_albert.py`` holds it to HF);
    its layouts the port does not run (two hidden groups, another
    activation) are refused, as is an unknown family."""
    for kw, match in (({"num_hidden_groups": 2}, "num_hidden_groups"),
                      ({"hidden_act": "relu"}, "hidden_act")):
        albert = transformers.AlbertForMaskedLM(transformers.AlbertConfig(
            vocab_size=64, embedding_size=16, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64, **kw))
        with pytest.raises(NotImplementedError, match=match):
            convert.from_hf(albert, device="cpu")

    class Unknown:
        class config:
            model_type = "gpt2"

    with pytest.raises(NotImplementedError, match="gpt2"):
        convert.from_hf(Unknown(), device="cpu")
