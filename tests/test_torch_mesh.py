"""The port's device mesh (tango_tpu_torch/parallel/mesh.py) in one process,
against JAX's (tango_tpu/parallel/mesh.py on the 8 virtual CPU devices):

  * the TP rules: for every parameter of a tiny UNet, a tiny music UNet and
    a tiny T5 encoder, the port's spec is JAX's `param_shardings` spec on the
    JAX leaf that `from_jax_params` maps onto it (the leaf found by filling
    each JAX leaf with its own index), JAX's (in, out) kernel spec read on
    the torch (out, in) weight;
  * the rank layout of `make_mesh(data, model)`, JAX's device order;
  * `process_local_batch_slice` tiling the batch across data ranks,
    `shard_batch` raising where the rows do not divide 'data', and
    `shard_batch_or_replicate` replicating exactly where JAX's does;
  * the backend rule, `init_distributed` without a launcher, and
    JAX_COORDINATOR without its process count;
  * `mesh=make_mesh()` in one process: `Tango.generate_for_batch` and an
    SFT step bit-equal to no mesh;
  * `shard_latents_seq`: the identity at model = 1, a rank's slab at
    model > 1 (the SP forward itself is tests/test_torch_sp.py's).

The multi-process runs are in tests/test_torch_parallel.py and
tests/test_torch_multihost.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tango_tpu import configs as JC
from tango_tpu.models.t5 import T5Encoder as JT5Encoder
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu.parallel import mesh as jmesh
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models.t5 import T5Encoder
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.parallel import mesh as pmesh
from tango_tpu_torch.pipeline import Tango
from tango_tpu_torch.utils.convert import from_jax_params

from tests.test_pipeline import TINY_T5
from tests.test_torch_pipeline import UNET_KW, VAE_KW
from tests.test_torch_pipeline_music import MUSIC_KW

torch.set_num_threads(1)


def _indexed_tree(init_fn):
    """JAX's parameter shapes, each leaf filled with its own index."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    return jax.tree_util.tree_unflatten(
        treedef, [np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])


def _jax_specs(tree):
    """{leaf index: JAX's spec on a 2 x 4 mesh}."""
    shardings = jmesh.param_shardings(tree, jmesh.make_mesh(data=2, model=4))
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    return {int(leaf.flat[0]): tuple(s.spec) for leaf, s in zip(leaves, specs)}


def _as_torch(spec: tuple, ndim: int) -> tuple:
    """JAX's spec on a Dense kernel (in, out), read on the torch weight (out, in)."""
    return tuple(reversed(spec)) if ndim == 2 and spec else spec


def _cases():
    unet_init = lambda cfg: lambda k: JUNet(cfg).init(  # noqa: E731
        k, jnp.zeros((1, 16, 4, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 2, 16)) if not cfg.extra_cond_streams else
        [jnp.zeros((1, 2, 16)), jnp.zeros((1, 3, cfg.extra_cond_dims[0])),
         jnp.zeros((1, 3, cfg.extra_cond_dims[1]))])["params"]
    t5_init = lambda k: JT5Encoder(TINY_T5).init(  # noqa: E731
        k, jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))["params"]
    return {
        "unet": (unet_init(JC.UNetConfig(**UNET_KW)),
                 lambda: UNet2DConditionModel(TC.UNetConfig(**UNET_KW))),
        "music_unet": (unet_init(JC.UNetConfig(**MUSIC_KW)),
                       lambda: UNet2DConditionModel(TC.UNetConfig(**MUSIC_KW))),
        "t5": (t5_init, lambda: T5Encoder(TC.T5Config.from_dict(TINY_T5.to_dict()))),
    }


@pytest.mark.parametrize("case", ["unet", "music_unet", "t5"])
def test_tp_rules_match_jax(case):
    init_fn, make = _cases()[case]
    tree = _indexed_tree(init_fn)
    want = _jax_specs(tree)
    sd = from_jax_params(tree)
    with torch.device("meta"):
        module = make()
    got = pmesh.param_shardings(module)
    assert set(got) == {n for n, _ in module.named_parameters()}
    sharded = 0
    for name, p in module.named_parameters():
        leaf = int(sd[name].flatten()[0])
        assert got[name] == _as_torch(want[leaf], p.dim()), name
        sharded += any(a is not None for a in got[name])
    assert sharded > 0


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8), (-1, 2)])
def test_rank_layout_is_jax_device_order(data, model):
    want = np.vectorize(lambda d: d.id)(jmesh.make_mesh(data=data, model=model).devices)
    np.testing.assert_array_equal(pmesh.rank_grid(8, data, model), want)
    with pytest.raises(ValueError):
        pmesh.rank_grid(8, 3, 2)


def _fake_mesh(data, model, rank):
    """Rank `rank`'s mesh object of a (data, model) grid, without groups:
    the batch helpers read only the layout."""
    return pmesh.Mesh(pmesh.rank_grid(data * model, data, model), rank, torch.device("cpu"))


def test_process_local_batch_slice_tiles_the_batch():
    data, model = 4, 2
    spans = {}
    for r in range(data * model):
        m = _fake_mesh(data, model, r)
        spans.setdefault(m.data_index, set()).add(
            (pmesh.process_local_batch_slice(m, 8).start,
             pmesh.process_local_batch_slice(m, 8).stop))
    # model ranks of one data index share a span; the spans tile [0, 8) in order
    assert all(len(v) == 1 for v in spans.values())
    flat = [next(iter(spans[d])) for d in range(data)]
    assert flat == [(0, 2), (2, 4), (4, 6), (6, 8)]
    # one process: the whole batch, as JAX's on one process
    sl = pmesh.process_local_batch_slice(pmesh.make_mesh(device="cpu"), 8)
    jsl = jmesh.process_local_batch_slice(jmesh.make_mesh(data=4, model=2), 8)
    assert (sl.start, sl.stop) == (jsl.start, jsl.stop) == (0, 8)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch({"x": torch.zeros(6)}, _fake_mesh(4, 2, 0))


@pytest.mark.parametrize("rows", [8, 4, 1, 3, 6, 12])
def test_shard_batch_or_replicate_matches_jax(rows):
    jm = jmesh.make_mesh(data=4, model=2)
    placed = jmesh.shard_batch_or_replicate({"x": np.zeros((rows, 2), np.float32)}, jm)["x"]
    jax_shards = tuple(placed.sharding.spec) == ("data",)
    for r in range(8):
        m = _fake_mesh(4, 2, r)
        got = pmesh.shard_batch_or_replicate({"x": torch.arange(rows)}, m)["x"]
        assert (len(got) < rows) == jax_shards
        if jax_shards:
            assert got.tolist() == list(range(rows))[pmesh.process_local_batch_slice(m, rows)]
        assert pmesh.local_rows(m, rows) == (pmesh.process_local_batch_slice(m, rows)
                                             if jax_shards else slice(0, rows))


def test_backend_rule_and_single_process_init(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pmesh.choose_backend(torch.device("cpu"), 1) == "gloo"
    assert pmesh.choose_backend(torch.device("cuda", 0), 1) == "nccl"
    assert pmesh.choose_backend(torch.device("cuda", 0), 2) == "gloo"  # a shared card
    for var in ("JAX_COORDINATOR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.init_distributed("cpu") == (0, 1, torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.is_main, mesh.data_group, mesh.model_group) == (
        {"data": 1, "model": 1}, 0, True, None, None)
    # "cuda" without an index, or no device: the local rank's card
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert pmesh.init_distributed("cuda")[2] == torch.device("cuda", 0) == chosen[-1]
    assert pmesh.init_distributed()[2] == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pmesh.init_distributed("cuda")[2] == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.init_distributed()
    monkeypatch.setenv("JAX_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="JAX_NUM_PROCESSES"):
        pmesh.init_distributed("cpu")


def test_split_span_and_sequence_parallel_raises():
    assert [pmesh.split_span(5, 2, i) for i in range(2)] == [(0, 3), (3, 5)]
    assert [pmesh.split_span(2, 4, i) for i in range(4)] == [(0, 1), (1, 2), (2, 2), (2, 2)]
    x = torch.arange(2 * 8 * 4 * 4, dtype=torch.float32).reshape(2, 8, 4, 4)
    assert pmesh.shard_latents_seq(x) is x
    assert pmesh.shard_latents_seq(x, pmesh.make_mesh(device="cpu")) is x
    # model = 2 (a mesh of two ranks, rank 1's place; no group is needed)
    mesh = pmesh.Mesh(pmesh.rank_grid(2, 1, 2), 1, torch.device("cpu"), "gloo")
    assert torch.equal(pmesh.shard_latents_seq(x, mesh), x[:, 4:])


def test_one_process_mesh_is_bit_equal_to_meshless():
    kw = dict(unet_config=TC.UNetConfig(**UNET_KW), vae_config=TC.VAEConfig(**VAE_KW),
              t5_config=TC.T5Config.from_dict(TINY_T5.to_dict()),
              hifigan_config=TC.HiFiGANConfig(num_mels=8, upsample_initial_channel=32),
              latent_t_size=16, latent_f_size=4, device="cpu", init_seed=2)
    call = dict(steps=2, batch_size=2, seed=4)
    prompts = ["a", "b", "c"]
    want = Tango.from_components(**kw).generate_for_batch(prompts, **call)
    got = Tango.from_components(**kw, mesh=pmesh.make_mesh(device="cpu")).generate_for_batch(
        prompts, **call)
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got) == 3

    from tests.test_torch_train import _batch, _gen, make_trainer

    steps = []
    for mesh in (None, pmesh.make_mesh(device="cpu")):
        trainer = make_trainer()
        trainer.mesh = mesh
        state = trainer.init_state(_gen(1))
        state, loss = trainer.train_step(state, _batch(), _gen(2))
        steps.append((loss, trainer.state_dict(state)))
    (l0, p0), (l1, p1) = steps
    assert torch.equal(l0, l1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
