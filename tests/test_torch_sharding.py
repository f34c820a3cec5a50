"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
reference's (``repro.runtime.sharding``), with no process started.

Every parameter leaf of the eleven architectures at full size (the port's
``LM`` on the meta device, the reference's ``abstract_params``) is paired
through the converter's name map (``repro_torch.convert._flatten``: the
reference's stacked ``layers/attn/wq`` is the port's ``layers.{i}.attn.
wq``) and its spec compared on the 16×16 and 2×16×16 production meshes
and on a 2×4 mesh (``jax.sharding.AbstractMesh``; the port reads any mesh
with ``axis_names`` and a ``shape`` mapping).  The reference stacks its
layers on a leading dim that is never sharded, so a layer leaf's spec
there is the port's with ``None`` in front.  Specs must be equal, and the
port's DTensor placements must be those of the reference's spec.  The
same holds for the batch, the decode state and the AdamW state, and
``pick_spec`` is held to the reference's on non-divisible dims.  A
reference tree and AdamW state carried across by the converter onto a 2×4
mesh (a fake process group of eight ranks in this process: this process is
rank 0) hold rank 0's shard of every leaf, as the reference's first shard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as ref_arch
from repro.models import lm as ref_lm
from repro.runtime import sharding as ref_shd
from repro_torch.compat import P, Replicate, Shard, placements
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.convert import (_flatten, adamw_state_from_reference,
                                 lm_params_from_reference)
from repro_torch.models import LM
from repro_torch.models.lm import init_decode_state
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import sharding as shd

ARCHS = ARCH_NAMES + ("repro-100m",)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _path(key_path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in key_path)


def _ref_leaves(cfg) -> dict:
    """``{port name: (reference path, reference shape)}`` for every leaf of
    the reference's abstract tree, through the converter's name map."""
    tree = jax.tree_util.tree_map_with_path(
        lambda p, leaf: (_path(p), tuple(leaf.shape)),
        ref_lm.abstract_params(cfg),
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    out: dict = {}
    for i in range(cfg.n_layers):
        _flatten(tree["layers"], f"layers.{i}.", out)
    for key in ("embed", "final_norm", "lm_head"):
        if key in tree:
            out[key] = tree[key]
    return out


def _norm(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh_name):
    cfg = get_arch(arch)
    mesh = _mesh(mesh_name)
    names = mesh.axis_names
    ref_leaves = _ref_leaves(ref_arch(arch))
    model = LM(cfg, dtype=torch.bfloat16, device="meta")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert sorted(shapes) == sorted(ref_leaves)
    plc = shd.param_shardings(cfg, mesh, model)
    sharded = 0
    for name, shape in shapes.items():
        path, ref_shape = ref_leaves[name]
        want = _norm(ref_shd._leaf_spec(path, ref_shape, ref_arch(arch),
                                        mesh))
        got = _norm(shd.leaf_spec(name, shape, cfg, mesh))
        if name.startswith("layers."):
            assert ref_shape == (cfg.n_layers,) + shape, name
            assert want[0] is None, (name, want)
            want = want[1:]
        else:
            assert ref_shape == shape, name
        assert got == want, (name, got, want)
        assert plc[name] == placements(P(*want), names), name
        sharded += any(s is not None for s in got)
    assert sharded > 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b",
                                  "musicgen-large", "llava-next-mistral-7b"])
def test_batch_state_and_adamw_placements_equal_reference(arch, mesh_name):
    cfg, rcfg = get_arch(arch), ref_arch(arch)
    mesh = _mesh(mesh_name)
    names = mesh.axis_names
    # the batch: divisible (256) and not (3) by the batch axes
    for B in (256, 3):
        toks = (B, 64, cfg.n_codebooks) if cfg.n_codebooks else (B, 64)
        ref_b = {"tokens": jax.ShapeDtypeStruct(toks, jnp.int32)}
        got = shd.batch_shardings(cfg, mesh, {
            "tokens": torch.empty(toks, device="meta")})
        want = ref_shd.batch_shardings(rcfg, mesh, ref_b)
        assert got["tokens"] == placements(P(*want["tokens"].spec), names)
    # the decode state: batch 128 (divisible) and 1, KV heads or sequence
    for B in (128, 1):
        ref_st = jax.eval_shape(lambda: ref_lm.init_decode_state(rcfg, B,
                                                                 4096))
        want = ref_shd.decode_state_shardings(rcfg, mesh, ref_st)
        st = init_decode_state(cfg, B, 4096, device="meta")
        got = shd.decode_state_shardings(cfg, mesh, st)
        for i, leaf in enumerate(st[:4]):
            if not isinstance(leaf, torch.Tensor):
                assert got[i] is None
                continue
            assert got[i] == placements(P(*want[i].spec), names), (B, i)
        assert got.pos is None and tuple(want.pos.spec) == ()
    # AdamW moments inherit the parameter placements; the step replicates
    model = LM(cfg, dtype=torch.bfloat16, device="meta")
    p_sh = shd.param_shardings(cfg, mesh, model)
    o_sh = shd.opt_state_shardings(cfg, mesh, p_sh)
    assert isinstance(o_sh, AdamWState)
    assert o_sh.m == p_sh and o_sh.v == p_sh
    assert o_sh.step == (Replicate(),) * len(names)


PICKS = [((10, 16), [(0, "model"), (1, "data")]),
         ((12, 6), [(0, ("data", "model")), (1, "model")]),
         ((16, 16), [(0, "model"), (1, "model"), (1, "data")]),
         ((3, 7), [(0, "data"), (1, "model")]),
         ((8, 4), [(0, ("pod", "data")), (1, "model")]),
         ((32,), [(0, "pod"), (0, "data")])]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape,prefs", PICKS)
def test_pick_spec_equals_reference_on_non_divisible_dims(shape, prefs,
                                                          mesh_name):
    mesh = _mesh(mesh_name)
    want = ref_shd.pick_spec(mesh, shape, prefs)
    got = shd.pick_spec(mesh, shape, prefs)
    assert isinstance(want, JP)
    assert tuple(got) == tuple(want)
    assert shd.batch_axes(mesh) == ref_shd.batch_axes(mesh)


def test_placements_of_specs():
    names = ("pod", "data", "model")
    assert placements(P(("pod", "data"), "model"), names) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements(P(None, "data"), names) == \
        (Replicate(), Shard(1), Replicate())
    assert placements(P(), names) == (Replicate(),) * 3


def _first_shard(arr, spec, sizes):
    """Rank 0's shard of ``arr`` under the reference's ``spec``."""
    idx = []
    for d, entry in enumerate(tuple(spec) + (None,) * (arr.ndim - len(spec))):
        n = 1
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            n *= sizes[a]
        idx.append(slice(0, arr.shape[d] // n))
    return arr[tuple(idx)]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b"])
def test_converter_places_reference_trees_on_a_mesh(arch):
    from repro.models.lm import init_params as ref_init
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro_torch.launch.dryrun import _mesh
    rcfg = ref_arch(arch, smoke=True)
    tree = jax.tree.map(np.asarray, ref_init(jax.random.key(0), rcfg,
                                             jnp.float32))
    state = ref_adamw_init(tree)
    state = type(state)(step=np.asarray(state.step) + 3,
                        m=jax.tree.map(lambda a: np.asarray(a) + 1.0, tree),
                        v=jax.tree.map(lambda a: np.asarray(a) * 2.0, tree))
    cfg = get_arch(arch, smoke=True)
    try:
        mesh = _mesh("2x4")
        model = lm_params_from_reference(tree, cfg, mesh=mesh)
        opt = adamw_state_from_reference(state, cfg, mesh=mesh)
        ref_mesh = AbstractMesh((2, 4), ("data", "model"))
        sizes = dict(data=2, model=4)
        flat = {}
        for i in range(cfg.n_layers):
            _flatten(jax.tree.map(lambda a: a[i], tree["layers"]),
                     f"layers.{i}.", flat)
        for key in ("embed", "final_norm", "lm_head"):
            if key in tree:
                flat[key] = tree[key]
        named = dict(model.named_parameters())
        assert sorted(named) == sorted(flat)
        for name, p in named.items():
            spec = shd.leaf_spec(name, tuple(p.shape), cfg, ref_mesh)
            want = _first_shard(np.asarray(flat[name]), spec, sizes)
            np.testing.assert_array_equal(p.to_local().numpy(), want)
            np.testing.assert_array_equal(opt.m[name].to_local().numpy(),
                                          want + 1.0)
            np.testing.assert_array_equal(opt.v[name].to_local().numpy(),
                                          want * 2.0)
        assert int(opt.step.to_local()) == 3
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
