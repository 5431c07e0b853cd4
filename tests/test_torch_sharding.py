"""The port's sharding rules, mesh hints and meshes
(`repro_torch.distributed.{sharding,hints}`, `repro_torch.launch.mesh`), on
the CPU, with exact equality throughout.

  * every config at its full shapes (the reference's from `jax.eval_shape`,
    the port's parameters and caches on the meta device: nothing is
    allocated), on (4, 4), (16, 16) and (2, 16, 16) meshes: the parameter
    and optimizer-state specs under `tp=False`, TP and FSDP, each port leaf
    (`layers.{i}.attn.wq`) holding the reference's spec of its stacked leaf
    (`segments/s/p/attn/wq`) with the repeat axis dropped; the batch specs
    of each SHAPES cell (data axes, and every axis as under dp_only), the
    decode cells' cache specs and the logits spec. The reference runs on an
    `AbstractMesh`; the port's rules take the axis sizes;
  * the reference's `TestParamSpecs` cases on the port;
  * `placements()` on 4 gloo ranks: `distribute_tensor` with each spec's
    placements gives every rank the block the spec names; and
    `make_production_mesh` under REPRO_TORCH_MESH_OVERRIDE there;
  * `make_production_mesh` over a fake process group of 256 and 512 ranks,
    its refusal with too few ranks, and `use_hints` nesting and reset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.compat import abstract_mesh
from repro.configs import get_arch as jget_arch
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from _torch_gloo import PLACEMENTS, run_ranks, verdicts

MESHES = {"4x4": ((4, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = {"replicated": dict(tp=False), "tp": dict(tp=True), "fsdp": dict(tp=True, fsdp=True)}
ARCHS = [cfg.name for cfg in ALL_ARCHS]
CACHE_CELLS = [name for name, s in SHAPES.items() if s.kind == "decode"]


def _sizes(mesh: str) -> dict:
    shape, axes = MESHES[mesh]
    return dict(zip(axes, shape))


def _ref_mesh(mesh: str):
    return abstract_mesh(*MESHES[mesh])


def _norm(spec) -> tuple:
    """A spec as `PartitionSpec` holds it: a one-name tuple is the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _spec(sharding) -> tuple:
    return _norm(sharding.spec)


def _layer_paths(cfg, root: str = "segments/") -> dict:
    """Layer i -> the reference's "segments/s/p" of its stacked leaves (a
    cache tree's "s/p")."""
    return {layer: f"{root}{s}/{p}"
            for s, seg_map in enumerate(T.segment_layers(cfg))
            for p, reps in enumerate(seg_map) for layer in reps}


def _ref_path(name: str, layer_paths: dict) -> str:
    """The reference path of a port parameter (or cache entry) name."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join([layer_paths[int(parts[1])], *parts[2:]])
    return "/".join(parts)


def _held(port: dict, ref: dict, layer_paths: dict) -> None:
    """Each port leaf's spec is its reference leaf's, the leading repeat
    axis of a stacked leaf dropped; every reference leaf is reached."""
    reached = set()
    for name, spec in port.items():
        path = _ref_path(name, layer_paths)
        want = ref[path]
        if name.startswith("layers.") and want:
            assert want[0] is None, path
            want = want[1:]
        assert _norm(spec) == want, (name, spec, want)
        reached.add(path)
    assert reached == set(ref)


@pytest.fixture(scope="module")
def models():
    """arch -> (port cfg, port meta params, reference param shapes)."""
    out = {}
    for cfg in ALL_ARCHS:
        jcfg = jget_arch(cfg.name)
        shapes = jax.eval_shape(lambda jcfg=jcfg: JT.init_params(jax.random.PRNGKey(0), jcfg))
        out[cfg.name] = (cfg, T.init_params(cfg, device="meta"), jcfg, shapes)
    return out


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_equal_the_reference(models, arch, mesh, policy):
    cfg, params, jcfg, shapes = models[arch]
    kw = POLICIES[policy]
    sizes, jmesh = _sizes(mesh), _ref_mesh(mesh)
    paths = _layer_paths(cfg)

    def ref(tree):  # an AdamWState field's path starts ".mu/"
        return {JSH._path_str(p).removeprefix("."): _spec(s)
                for p, s in jax.tree_util.tree_leaves_with_path(tree)}

    _held(SH.param_shardings(sizes, params, **kw), ref(JSH.param_shardings(jmesh, shapes, **kw)),
          paths)
    state = SH.opt_state_shardings(sizes, O.init(dict(params.named_parameters())), **kw)
    jstate = ref(JSH.opt_state_shardings(jmesh, jax.eval_shape(JO.init, shapes), **kw))
    assert state.step == jstate.pop("step") == ()
    for tree in ("mu", "nu"):
        _held(getattr(state, tree), {p.removeprefix(tree + "/"): s for p, s in jstate.items()
                                     if p.startswith(tree + "/")}, paths)


def _batch_shapes(cfg, cell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    if cfg.modality == "audio_tokens":
        return {"tokens": (b, s, cfg.n_codebooks)}
    if cfg.modality == "vision_text":
        return {"tokens": (b, s - cfg.vision_tokens),
                "patch_embeds": (b, cfg.vision_tokens, cfg.vision_dim)}
    return {"tokens": (b, s)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_logits_specs_equal_the_reference(models, arch, mesh):
    cfg, _, jcfg, _ = models[arch]
    sizes, jmesh = _sizes(mesh), _ref_mesh(mesh)
    for cell in SHAPES.values():
        shapes = _batch_shapes(cfg, cell)
        jshapes = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
        for axes in (None, MESHES[mesh][1]):
            got = SH.batch_shardings(sizes, {k: torch.empty(v, device="meta")
                                             for k, v in shapes.items()}, batch_axes=axes)
            want = JSH.batch_shardings(jmesh, jshapes, batch_axes=axes)
            assert {k: _norm(v) for k, v in got.items()} == {k: _spec(v) for k, v in want.items()}, \
                (cell.name, axes)
    paths = _layer_paths(cfg, root="")
    for name in CACHE_CELLS:
        b, s = SHAPES[name].global_batch, SHAPES[name].seq_len
        got = SH.cache_shardings(sizes, T.make_cache(cfg, b, s, device="meta"))
        jcache = jax.eval_shape(lambda: JT.make_cache(jcfg, b, s, dtype=jnp.bfloat16))
        want = {JSH._path_str(p): _spec(v) for p, v in
                jax.tree_util.tree_leaves_with_path(JSH.cache_shardings(jmesh, jcache))}
        assert len(got) == cfg.n_layers
        _held({f"layers.{i}.{k}": v for i, layer in enumerate(got) for k, v in layer.items()},
              want, paths)
    for batched in (True, False):
        assert _norm(SH.logits_sharding(sizes, batched)) == \
            _spec(JSH.logits_sharding(jmesh, batched))


# ---------------------------------------------------------------------------
# the reference's TestParamSpecs cases, on the port (a (4, 4) mesh)
# ---------------------------------------------------------------------------

MESH16 = {"data": 4, "model": 4}


def _param_spec(name, shape, stacked=False):
    return SH._param_spec(name.replace("/", "."), shape, MESH16, stacked)


def test_attention_heads_shard_when_divisible():
    assert _param_spec("attn/wq", (1024, 8, 128)) == (None, "model", None)


def test_small_head_count_falls_back_to_head_dim():
    # 2 heads cannot shard over a 4-way model axis; Dh = 128 can
    assert _param_spec("attn/wq", (1024, 2, 128)) == (None, None, "model")


def test_single_kv_head_falls_back():
    assert _param_spec("attn/wk", (1152, 1, 256)) == (None, None, "model")


def test_stacked_leading_axis_never_sharded():
    s = _param_spec("segments/0/attn/wq", (24, 1024, 8, 128), stacked=True)
    assert s[0] is None and "model" in s


def test_norms_replicate():
    assert _param_spec("ln1", (1024,)) == (None,)


def test_experts_shard_over_model():
    assert _param_spec("moe/wi_gate", (64, 2048, 1408)) == ("model", None, None)


def test_vocab_shards():
    assert _param_spec("embed", (256000, 2304)) == ("model", None)


def test_fsdp_extends_over_data():
    assert SH._extend_fsdp(("model", None), (256000, 2304), MESH16, stacked=False) \
        == ("model", ("data",))


# ---------------------------------------------------------------------------
# placements() and the override on 4 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    return run_ranks("mesh", 4, out), verdicts(out, 4)


def _block(full: np.ndarray, spec: tuple, axes: tuple, shape: tuple, coord) -> np.ndarray:
    """The block of `full` that a rank at mesh coordinate `coord` holds
    under `spec` (a tuple of axes shards major first)."""
    index = []
    for d, entry in enumerate(list(spec) + [None] * (full.ndim - len(spec))):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        k, n = 0, 1
        for name in names:
            i = axes.index(name)
            k, n = k * shape[i] + coord[i], n * shape[i]
        size = full.shape[d] // n
        index.append(slice(k * size, (k + 1) * size))
    return full[tuple(index)]


@pytest.mark.parametrize("case", range(len(PLACEMENTS)))
def test_placements_give_each_rank_its_block(mesh_run, case):
    shape, axes, spec, tshape = PLACEMENTS[case]
    full = np.arange(int(np.prod(tshape)), dtype=np.float32).reshape(tshape)
    for r, arrays in enumerate(mesh_run[0]):
        want = _block(full, spec, axes, shape, arrays[f"coord/{case}"])
        np.testing.assert_array_equal(arrays[f"local/{case}"], want, err_msg=f"rank {r}")


def test_production_mesh_override_on_gloo(mesh_run):
    for r, info in enumerate(mesh_run[1]):
        assert info["2,2"] == [["data", "model"], [2, 2], [r // 2, r % 2]]
        assert info["1,2,2"] == [["pod", "data", "model"], [1, 2, 2], [0, r // 2, r % 2]]
        # a mesh of the first 2 of 4 ranks: the others hold no coordinate
        assert info["1,2"] == [["data", "model"], [1, 2], [0, r] if r < 2 else None]


# ---------------------------------------------------------------------------
# production meshes over a fake process group, and the hints
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_group():
    """A fake default group of `world` ranks, this process rank 5; destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def join(world: int):
        dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=world)

    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


def test_production_mesh_needs_its_ranks(fake_group, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_MESH_OVERRIDE", raising=False)
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    fake_group(256)
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    mesh = make_production_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (16, 16)
    assert SH.axis_sizes(mesh) == {"data": 16, "model": 16}
    assert tuple(mesh.get_coordinate()) == (0, 5)


def test_production_mesh_two_pods(fake_group):
    fake_group(512)
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert SH.axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
    with H.use_hints(mesh):
        assert H.get_hints().data_axes == ("pod", "data")
        assert H.get_hints().model_axis == "model"


def test_use_hints_nests_and_resets(fake_group):
    fake_group(512)
    pods = make_production_mesh(multi_pod=True, device="cpu")
    data_only = make_debug_mesh((512,), ("data",), device="cpu")
    assert H.get_hints() is None
    with H.use_hints(pods, fsdp=True):
        outer = H.get_hints()
        assert outer.mesh is pods and outer.fsdp
        with H.use_hints(data_only):
            inner = H.get_hints()
            assert inner.mesh is data_only and inner.data_axes == ("data",)
            assert inner.model_axis is None and not inner.fsdp
        assert H.get_hints() is outer
        with pytest.raises(KeyError), H.use_hints(data_only):
            raise KeyError("the hints reset on an exception too")
        assert H.get_hints() is outer
    assert H.get_hints() is None
