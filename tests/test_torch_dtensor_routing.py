"""The model code's DTensor routing (the dry run's path,
``repro_torch.launch.dryrun``) with real values: every family's smoke
config with its parameters, batches and caches distributed by the sharding
rules over a 2 x 2 (data, model) mesh of 4 gloo ranks on the CPU, against
the same model on plain tensors: a train step's loss and every gradient,
a prefill's logits and cache, three decode steps' logits.

The cases cover each routed piece: the vocab-parallel embedding and
cross-entropy (every case), head-sharded caches (llama3.2-1b,
whisper-medium's cross K/V), sequence-sharded caches with the mesh-split
``swa_decode`` and per-shard K/V writes (yi-9b, recurrentgemma-2b's ring),
heads that do not split (smollm-360m, 3 heads), SSD's chunks per shard
(mamba2-1.3b), M-RoPE and the patch splice (qwen2-vl-72b), and
granite-moe-1b-a400m's ragged path per data shard and ``ep`` under
``local_map`` (``ep`` at a capacity that drops nothing and without the
aux loss, which JAX too averages per shard, so that it equals the dense
path). The sums over ranks run in another order: each difference is held
within ``TOL`` of its reference's magnitude.
"""
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

from torch_parity import run_ranks
import torch_ranks

CASES = [("llama3.2-1b", None), ("yi-9b", None), ("smollm-360m", None),
         ("recurrentgemma-2b", None), ("mamba2-1.3b", None),
         ("whisper-medium", None), ("qwen2-vl-72b", None),
         ("granite-moe-1b-a400m", "ep"), ("granite-moe-1b-a400m", "ragged")]
TOL = 5e-5
RANK_TIMEOUT = 400.0


@pytest.fixture(scope="module")
def routed():
    return run_ranks(torch_ranks.dtensor_routing, 4, RANK_TIMEOUT, CASES)


def test_device_mesh_axes_collectives(routed):
    """``DeviceMeshAxes`` (``ep``'s mesh in the dry run) over the 2 x 2
    mesh: rank r at (r // 2, r % 2); sums over ``model``, gathers over
    ``data`` in coordinate order."""
    for rank, rank_out in enumerate(routed):
        axes = rank_out["axes"]
        assert axes["index"] == [rank // 2, rank % 2]
        pair = 2 * (rank // 2)
        assert axes["psum"] == [float(pair + pair + 1)]
        col = rank % 2
        assert axes["gather"] == [[col, 10 * col], [col + 2, 10 * (col + 2)]]


@pytest.mark.parametrize("arch,impl", CASES)
def test_dtensor_routing_matches_plain_tensors(routed, arch, impl):
    for rank_out in routed:
        res = rank_out[f"{arch}:{impl}"]
        for what in ("loss", "grads", "prefill", "cache", "decode"):
            assert res[what] <= TOL, (what, res)
