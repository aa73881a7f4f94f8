"""The port's tp, pp and ep (``wicca_tpu_torch.parallel.model_parallel``) in
a 4-rank gloo world on the CPU against ``wicca_tpu.parallel.model_parallel``
on a 4-device model mesh of the pytest process, the JAX parameters carried
across with ``from_jax_params`` (the cases of
``tests/test_model_parallel.py``).

Tolerance: float32 within ``rtol`` 1e-5 and ``atol`` 1e-5 of JAX's (JAX's
own test holds its mesh programs so against their oracles: the matmuls sum
in other orders).
"""

import jax
import numpy as np
import pytest
import torch

from tests import _torch_mesh_ranks as R
from wicca_tpu.parallel import model_parallel as mp
from wicca_tpu_torch.parallel import model_parallel as tmp
from wicca_tpu_torch.parallel import run_world

RTOL = ATOL = 1e-5
N = 4


def _put(params, shardings):
    return {k: jax.device_put(v, shardings[k]) for k, v in params.items()}


@pytest.fixture(scope="module")
def cases():
    """JAX's parameters, inputs and mesh outputs, and the port's world."""
    mesh = mp.model_mesh(jax.devices()[:N])
    params = {"tp": mp.tp_mlp_init(jax.random.PRNGKey(0), d_in=24, d_hidden=64, d_out=10),
              "pp": mp.pp_stages_init(jax.random.PRNGKey(2), N, d=16),
              "pp_double": mp.pp_stages_init(jax.random.PRNGKey(8), 2 * N, d=16),
              "ep": mp.moe_init(jax.random.PRNGKey(4), n_experts=2 * N, d=12, d_hidden=32)}
    inputs = {"tp": jax.random.normal(jax.random.PRNGKey(1), (7, 24)),
              "pp": jax.random.normal(jax.random.PRNGKey(3), (5, 4, 16)),
              "ep": jax.random.normal(jax.random.PRNGKey(5), (33, 12))}
    want = {"tp": mp.tp_mlp_apply(_put(params["tp"], mp.tp_mlp_shardings(mesh)), inputs["tp"], mesh),
            "pp": mp.pp_apply(_put(params["pp"], mp.pp_stage_shardings(mesh)), inputs["pp"], mesh),
            "ep": mp.moe_apply(_put(params["ep"], mp.moe_shardings(mesh)), inputs["ep"], mesh)}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    got = run_world(R.model_parallel_checks, N, to_np(params), to_np(inputs), backend="gloo", device_type="cpu",
                    timeout_s=120)
    return to_np(params), to_np(inputs), to_np(want), got


@pytest.mark.parametrize("name", ["tp", "pp", "ep"])
def test_matches_jax_with_carried_parameters(cases, name):
    params, inputs, want, got = cases
    for rank in got:  # every rank returns the whole result
        np.testing.assert_allclose(rank[name], want[name], rtol=RTOL, atol=ATOL)
    oracle = {"tp": tmp.tp_mlp_reference, "pp": tmp.pp_reference, "ep": tmp.moe_reference}[name]
    single = oracle(tmp.from_jax_params(params[name]), torch.from_numpy(np.array(inputs[name])))
    np.testing.assert_allclose(single.numpy(), want[name], rtol=RTOL, atol=ATOL)


def test_tp_takes_sharded_parameters(cases):
    _, _, want, got = cases
    np.testing.assert_allclose(got[0]["tp_dtensor"], want["tp"], rtol=RTOL, atol=ATOL)


def test_pipeline_stage_count_mismatch_raises(cases):
    assert all("one stage per device" in rank["mismatch"] for rank in cases[3])


def test_moe_routing_actually_spreads(cases):
    params, inputs, _, _ = cases
    choice = np.argmax(inputs["ep"] @ params["ep"]["gate"], axis=-1)
    assert len(set(choice.tolist())) > 1
