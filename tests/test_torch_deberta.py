"""The port's DeBERTa beat predictor (tango_tpu_torch/models/deberta.py)
against the deberta_tiny golden (HF DebertaV2Model's trunk with the
reference's head) and against JAX's DebertaV2ForBeats on random weights, on
the CPU in f32, at tests/test_deberta.py's tolerance (3e-4 / 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tango_tpu.models import deberta as jdeberta
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models import deberta
from tango_tpu_torch.utils.convert import from_jax_params
from tango_tpu_torch.utils.export import export_deberta_beats
from tango_tpu_torch.utils.init import init_random_

from tests._torch_helpers import random_jax_params
from tests.conftest import load_golden

torch.set_num_threads(1)

# tests/test_deberta.py's TINY
TINY_KW = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=48, max_position_embeddings=32, position_buckets=8)
TINY = TC.DebertaConfig(**TINY_KW)


def golden_sd():
    g = load_golden("deberta_tiny")
    return g, {k[4:]: torch.from_numpy(np.array(g[k])) for k in g.files if k.startswith("sd::")}


def model_from(sd, cfg=TINY):
    m = deberta.DebertaV2ForBeats(cfg)
    m.load_state_dict(sd)
    return m.eval()


@pytest.mark.parametrize("size,buckets,max_pos", [(16, 8, 32), (40, 8, 32), (512, 256, 512),
                                                  (7, 0, 0)])
def test_relative_positions_match_jax(size, buckets, max_pos):
    got = deberta.build_relative_position(size, size, buckets, max_pos)
    np.testing.assert_array_equal(got, jdeberta.build_relative_position(size, size, buckets,
                                                                        max_pos))
    rel = np.arange(-600, 600)
    np.testing.assert_array_equal(deberta.make_log_bucket_position(rel, 256, 512),
                                  jdeberta.make_log_bucket_position(rel, 256, 512))


def test_config_matches_jax():
    assert TC.DEBERTA_V3_LARGE == TC.DebertaConfig.from_dict(jdeberta.DEBERTA_V3_LARGE.to_dict())
    assert TINY == TC.DebertaConfig.from_dict(jdeberta.DebertaConfig(**TINY_KW).to_dict())


def test_beats_head_matches_golden():
    g, sd = golden_sd()
    model = model_from(deberta.convert_deberta_beats(sd))
    with torch.no_grad():
        logits, values = model(torch.from_numpy(g["ids"]), torch.from_numpy(g["mask"]))
    mask = g["mask"].astype(bool)
    np.testing.assert_allclose(logits.numpy()[mask], g["logits"][mask], atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(values.numpy()[mask], g["values"][mask], atol=3e-4, rtol=1e-3)


def test_mask_is_respected():
    """Changing only masked-out tokens changes no unmasked output; a fully
    masked row gives finite outputs (XSoftmax zeroes its attention)."""
    g, sd = golden_sd()
    model = model_from(deberta.convert_deberta_beats(sd))
    ids, mask = torch.from_numpy(g["ids"]), torch.from_numpy(g["mask"])
    n = int(mask[0].sum())
    assert n < ids.shape[1]
    ids2 = ids.clone()
    ids2[0, n:] = 5
    with torch.no_grad():
        l1, v1 = model(ids, mask)
        l2, v2 = model(ids2, mask)
        l3, _ = model(ids, torch.zeros_like(mask))
    torch.testing.assert_close(l1[0, :n], l2[0, :n], atol=1e-5, rtol=0)
    torch.testing.assert_close(v1[0, :n], v2[0, :n], atol=1e-5, rtol=0)
    assert torch.isfinite(l3).all()


def test_converter_and_exporter_are_bit_exact():
    """convert_deberta_beats matches JAX's converter through from_jax_params,
    and export_deberta_beats gives back the reference keys and tensors."""
    g, sd = golden_sd()
    got = deberta.convert_deberta_beats(sd)
    want = from_jax_params(jdeberta.convert_deberta_beats({k: v.numpy() for k, v in sd.items()}))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    back = export_deberta_beats(got)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("share_att_key", [True, False])
def test_matches_jax_on_random_weights(share_att_key):
    """Random weights (nonzero biases, non-unit norm scales), a padded row,
    sequences past the bucket span; with and without shared position
    projections."""
    kw = dict(TINY_KW, share_att_key=share_att_key)
    jmodel = jdeberta.DebertaV2ForBeats(jdeberta.DebertaConfig(**kw))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 96, (2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 23:] = 0
    params = random_jax_params(lambda k: jmodel.init(k, jnp.asarray(ids), jnp.asarray(mask))
                               ["params"], 1)
    jl, jv = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    model = model_from(from_jax_params(params), TC.DebertaConfig(**kw))
    with torch.no_grad():
        pl, pv = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    m = mask.astype(bool)
    np.testing.assert_allclose(pl.numpy()[m], np.asarray(jl)[m], atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(pv.numpy()[m], np.asarray(jv)[m], atol=3e-4, rtol=1e-3)


def test_random_init_draws_the_tables_at_jax_scale():
    with torch.device("meta"):
        m = deberta.DebertaV2ForBeats(TINY)
    m = init_random_(m.to_empty(device="cpu"), torch.Generator().manual_seed(0))
    for table in (m.word_embeddings.weight, m.rel_embeddings.weight):
        assert 0.01 < float(table.std()) < 0.03
    assert torch.equal(m.emb_ln.weight, torch.ones(32))
