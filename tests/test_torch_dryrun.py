"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its CLI
against JAX's, and its tallies at smoke width against plain-tensor
counts and JAX's specs.

The dry run makes a fake process group, so it runs in subprocesses here
(the group never meets another test's): one at smoke width (llama3.2-1b's
smoke config on 1 x 1, 2 x 2 and 1 x 4 (data, model) meshes) and one of
the CLI at full width (llama3.2-1b ``train_4k`` on the 16 x 16 mesh, the
command the README gives).
"""
import argparse
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.sharding import compat as jcompat
from repro.sharding import rules as jrules
from repro_torch.launch import dryrun

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
B, S = 2, 32

_SMOKE_SIDE = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models import transformer
from repro_torch.sharding import rules
from repro_torch.training.adamw import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

B, S = int(sys.argv[1]), int(sys.argv[2])
cfg = configs.get_smoke("llama3.2-1b")
meta = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
batch = {"tokens": meta(B, S), "labels": meta(B, S)}
out = {}
for sizes in ((1, 1), (2, 2)):
    mesh = dryrun.fake_mesh(sizes, ("data", "model"))
    out["x".join(map(str, sizes))] = dryrun.measure(cfg, "train_4k", mesh,
                                                    batch_shapes=batch)

# the same step on real CPU tensors under FlopCounterMode
state = init_train_state(cfg, seed=0, device="cpu")
real = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32)}
real["labels"] = real["tokens"]
step = make_train_step(cfg, AdamWConfig(total_steps=10_000))
with FlopCounterMode(display=False) as fc:
    step(state, real)
out["real_flops"] = fc.get_total_flops()

# the dense forward on a 1 x 4 mesh: the Megatron pattern
mesh = dryrun.fake_mesh((1, 4), ("data", "model"))
with FakeTensorMode():
    model, _ = dryrun.dtensor_model(cfg, mesh, trainable=False)
    tokens = dryrun.fake_dtensor((B, S), torch.int32, rules.P("data"), mesh)
    logits, tally, counts = dryrun.trace(
        lambda m, t: transformer.forward(m, {"tokens": t}, cfg),
        (model, tokens))
out["forward_1x4"] = dryrun.collectives(tally, counts)
out["forward_1x4"]["logits"] = [str(p) for p in logits.placements]

# the ragged MoE path (bf16: the grouped product's shape rule wants it)
import dataclasses
ragged = dataclasses.replace(configs.get_smoke("granite-moe-1b-a400m"),
                             moe_impl="ragged", dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16)
mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
out["ragged"] = dryrun.measure(ragged, "train_4k", mesh,
                               batch_shapes=batch)["replicated_ops"]

# an op with no DTensor strategy (a custom one on the prefill's logits),
# traced twice: registered replicated, named in both runs
lib = torch.library.Library("dryrun_test", "DEF")
lib.define("ident(Tensor x) -> Tensor")
lib.impl("ident", lambda x: x.clone(), "CompositeExplicitAutograd")
torch.library.register_fake("dryrun_test::ident")(
    lambda x: torch.empty_like(x))
logits = transformer._logits
transformer._logits = lambda *a: torch.ops.dryrun_test.ident(logits(*a))
prompt = {"tokens": meta(B, S)}
out["fallback"] = [dryrun.measure(cfg, "prefill_32k", mesh,
                                  batch_shapes=prompt, cache_len=S)
                   ["replicated_ops"] for _ in range(2)]
print(json.dumps(out))
"""


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=_SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def smoke():
    out = _run(["-c", _SMOKE_SIDE, str(B), str(S)], timeout=300)
    return json.loads(out.strip().splitlines()[-1])


def test_local_flops_equal_flop_counter_on_real_tensors(smoke):
    """At 1 x 1 every local shape is the global one: the dry run's local
    FLOPs are FlopCounterMode's over the same step on real CPU tensors."""
    assert smoke["1x1"]["flops_per_device"] == smoke["real_flops"] > 0
    # on 2 x 2 each rank does a share of the products
    assert smoke["2x2"]["flops_per_device"] < smoke["real_flops"] / 2


def _local_bytes(tree, specs, mesh_shape):
    """Bytes of the local shards of a JAX tree of ShapeDtypeStructs under
    its specs."""
    total = 0
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs,
                                  is_leaf=lambda x: isinstance(x, jax.sharding
                                                               .PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for d, axes in enumerate(spec):
            if axes is None:
                continue
            for a in ((axes,) if isinstance(axes, str) else axes):
                shape[d] //= mesh_shape[a]
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", ["1x1", "2x2"])
def test_argument_bytes_equal_jax_specs_local_shards(smoke, mesh):
    """The train step's arguments (params, both moments, the two steps,
    the batch) in local shard bytes, reckoned from JAX's specs of JAX's
    smoke config (f32, as the port's)."""
    sizes = tuple(int(x) for x in mesh.split("x"))
    jmesh = jcompat.abstract_mesh(sizes, ("data", "model"))
    cfg = jconfigs.get_smoke("llama3.2-1b")
    params = jax.eval_shape(lambda k: jtransformer.init_params(k, cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    mesh_shape = dict(zip(("data", "model"), sizes))
    p_bytes = _local_bytes(params, jrules.param_specs(params, jmesh),
                           mesh_shape)
    f32 = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float32),
                       params)
    m_bytes = _local_bytes(f32, jrules.param_specs(f32, jmesh), mesh_shape)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    b_bytes = _local_bytes(batch, jrules.batch_specs(batch, jmesh),
                           mesh_shape)
    expect = p_bytes + 2 * m_bytes + 2 * 4 + b_bytes
    assert smoke[mesh]["memory"]["argument_size_in_bytes"] == expect
    mem = smoke[mesh]["memory"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["generated_code_size_in_bytes"] is None
    assert mem["alias_size_in_bytes"] is None
    assert smoke[mesh]["replicated_ops"] == []


def test_megatron_pattern_on_1x4(smoke):
    """The dense forward with ``model`` 4: one all-reduce of the (B, S, D)
    activations after each row-parallel product (``wo``, ``wd``) and one
    for the vocab-sharded embedding; the logits stay vocab-sharded."""
    cfg = jconfigs.get_smoke("llama3.2-1b")
    f = smoke["forward_1x4"]
    act = B * S * cfg.d_model * 4
    ar = f["by_kind"]["all-reduce"]
    assert ar["count"] == 2 * cfg.num_layers + 1
    assert ar["result_bytes"] == ar["count"] * act
    assert f["logits"][-1] == "S(2)"       # Shard(2): vocab-sharded
    # the kv heads (2 of them) do not split over 4 ranks: K and V are
    # gathered before their heads are split, once each a layer
    assert f["by_kind"]["all-gather"]["count"] == 2 * cfg.num_layers
    assert set(f["by_kind"]) == {"all-reduce", "all-gather"}
    assert f["wire_bytes"] == 2 * ar["result_bytes"] + \
        f["by_kind"]["all-gather"]["result_bytes"]


def test_op_without_strategy_runs_replicated_and_is_named(smoke):
    """An op DTensor has no sharding strategy for is registered replicated
    and named in ``replicated_ops``, in every trace that runs it, the first
    and later ones alike; the ragged MoE path (sort, grouped products) runs
    per data shard and needs none."""
    assert smoke["fallback"] == [["dryrun_test.ident.default"]] * 2
    assert smoke["ragged"] == []


def _flags(ap: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     type(a).__name__, a.nargs)
            for a in ap._actions if a.dest != "help"}


def test_cli_flags_equal_jax():
    """The flags, their defaults and choices are JAX's, but for
    ``--outdir``'s default (``results/dryrun_torch``)."""
    import jax as _jax
    _jax.devices()                  # JAX's dryrun sets XLA_FLAGS on import
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    captured = {}

    def grab(self, *a, **k):
        captured["parser"] = self
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jdryrun.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    jflags, tflags = _flags(captured["parser"]), _flags(dryrun.parser())
    assert tflags.pop("outdir")[1] == "results/dryrun_torch"
    assert jflags.pop("outdir")[1] == "results/dryrun"
    assert tflags == jflags


def test_cli_full_width_llama_train(tmp_path):
    """The README's command on the CPU: llama3.2-1b train_4k on 16 x 16
    writes JAX's keys, the H100 constants and no replicated op."""
    out = _run(["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
                "--shape", "train_4k", "--outdir", str(tmp_path)],
               timeout=600)
    assert "[ok]   llama3.2-1b" in out and "all dry-runs passed" in out
    res = json.loads((tmp_path / "llama3.2-1b__train_4k__16x16.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "chips", "tag", "moe_impl", "remat",
                "overrides", "ok", "extrapolated", "trace_s", "memory",
                "flops_per_device", "bytes_per_device", "collectives",
                "roofline", "model_flops_total", "model_flops_per_device",
                "useful_flops_ratio", "params_total", "params_active",
                "replicated_ops", "constants"):
        assert key in res, key
    assert res["ok"] and res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["replicated_ops"] == []
    assert set(res["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "bottleneck"}
    assert res["constants"]["peak_flops"] == 989e12
    assert res["constants"]["hbm_bytes_per_s"] == 3.35e12
    assert res["constants"]["link_bytes_per_s"] == 50e9
    assert set(res["collectives"]["by_kind"]) <= {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
    cfg = dryrun.build_config("llama3.2-1b", "train_4k")
    assert res["params_total"] == dryrun.param_count(cfg)
    # the arguments (bf16 params + two f32 moments, 10 bytes a parameter)
    # are mostly sharded 16 ways: under an eighth of the unsharded bytes
    assert res["memory"]["argument_size_in_bytes"] < \
        10 * res["params_total"] / 8
