"""The port's data axis and sharded fusion over two gloo processes, against
one process and the JAX package on the CPU.

The ranks are one ``cermvs_torch.parallel.dryrun.World`` of two spawned
processes, started once for the module, which import the port alone
(``tests/torch_parallel_tasks.py``); the JAX side runs here, on two of
the eight CPU devices of ``tests/conftest.py``.

* ``train()`` data parallel over two ranks on ``tests/multihost_worker.py``'s
  synthetic set (batch 4 as 2 + 2, rectified, fp32, four steps): the
  ranks' local plans of the first batch differ and the union they exchange
  is the same on both; their weights are equal, and match one process's
  run at rtol 1e-3 / atol 2e-5, ``tests/test_multihost.py``'s tolerance
  (the process-local split sums the gradients in another order; over four
  AdamW steps at lr 2.5e-4 that moves a few weights by ~1e-5).
* One data-parallel step (batch 2 as 1 + 1, exact, ``tests/test_training.py``'s
  batch and cascade) against the JAX package's ``make_train_step`` on a
  (2, 1) mesh, the port's seeded weights carried to JAX with
  ``convert_raft``: loss and metrics rtol 1e-5, grad_norm rtol 1e-4 and
  the new weights atol 1e-6 (``tests/test_torch_train_step.py``'s, which
  holds the same step on one device).
* ``fusion()`` with ``multihost`` over two ranks on the JAX package's
  multi-host fusion scene: exactly the single-process cloud, and JAX's at
  rtol 1e-5 (``tests/test_torch_fusion.py``'s).
* The dry run at its CPU sizes, the rectified forward with the mean, max
  and std aggregation among its cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cermvs_tpu.models.raft import RAFT as JRAFT
from cermvs_tpu.parallel.mesh import make_mesh as j_make_mesh
from cermvs_tpu.pipeline.fusion import fusion as j_fusion
from cermvs_tpu.training.optim import fetch_optimizer as j_fetch
from cermvs_tpu.training.step import TrainState as JState
from cermvs_tpu.training.step import make_train_step
from cermvs_tpu.utils.torch_import import convert_raft
from cermvs_torch.io.ply import read_ply
from cermvs_torch.ops.rectify import unpack_plan
from cermvs_torch.parallel import dryrun
from cermvs_torch.pipeline.fusion import fusion
import torch_parallel_tasks as tasks
from multihost_fusion_worker import make_loader
from test_training import TINY, _tiny_batch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here, as in the ranks (tiny shapes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    w = dryrun.World(2, "cpu")
    yield w
    w.close()


def test_two_process_train_matches_one(world, tmp_path):
    two = world.run(tasks.train_synth, str(tmp_path / "two"))
    one = world.run(tasks.train_synth, str(tmp_path / "one"), False)[0]
    assert all(r["grouped"] and not r["graphs"] for r in two)
    assert not one["grouped"]
    assert two[0]["step"] == two[1]["step"] == one["step"] == 4
    # each rank planned its own samples; the exchange gave one union
    assert not np.array_equal(two[0]["plan_local"], two[1]["plan_local"])
    np.testing.assert_array_equal(two[0]["plan_union"], two[1]["plan_union"])
    union = unpack_plan(two[0]["plan_union"], tasks.SYNTH_N - 1)
    assert union.ok and all(
        union.covers(unpack_plan(r["plan_local"], tasks.SYNTH_N - 1))
        for r in two)
    w0, w1 = two[0]["weights"], two[1]["weights"]
    assert np.isfinite(w0).all()
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_allclose(w0, one["weights"], rtol=1e-3, atol=2e-5)


def test_data_parallel_step_matches_jax(world):
    batch = {k: np.array(v)
             for k, v in _tiny_batch(np.random.RandomState(0)).items()}
    model = dict(cascade=TINY, hyp_chunk=4, dtype="float32")
    port = tasks.seeded_model(model, 1e-3, test_mode=False)
    params = convert_raft({k: v.numpy().copy()
                           for k, v in port.state_dict().items()})["params"]
    tx, _ = j_fetch(num_steps=50)
    jmodel = JRAFT(cascade=TINY, hyp_chunk=4, dtype=jnp.float32, remat=True)
    mesh = j_make_mesh(n_data=2, n_view=1, devices=jax.devices()[:2])
    step = make_train_step(jmodel, tx, mesh=mesh, donate=False)
    js, mj = step(JState(jnp.zeros((), jnp.int32), params, tx.init(params)),
                  {k: jnp.asarray(v) for k, v in batch.items()}, 0.5)
    res = world.run(tasks.dp_step, model, 1e-3, batch, 50)
    (m0, sd0), (m1, sd1) = res
    assert m0 == m1
    assert set(m0) == set(mj)
    for k in m0:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(m0[k], float(mj[k]), rtol=tol, atol=1e-7,
                                   err_msg=k)
    new = convert_raft(sd0)["params"]
    flat_j = jax.tree_util.tree_leaves(js.params)
    flat_p = jax.tree_util.tree_leaves(new)
    flat_o = jax.tree_util.tree_leaves(params)
    assert len(flat_j) == len(flat_p) > 40
    moved = 0.0
    for a, b, o in zip(flat_j, flat_p, flat_o):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=1e-6)
        moved = max(moved, float(np.abs(np.asarray(b) - o).max()))
    assert moved > 1e-4  # the step moved the weights by about lr
    for k in sd0:
        np.testing.assert_array_equal(sd0[k], sd1[k])


def test_two_process_fusion_is_one_process_cloud(world, tmp_path):
    n, H, W = 8, 24, 32
    dryrun.write_fusion_scene(str(tmp_path), n, H, W,
                              folders=("two", "one", "jax"))
    kw = dict(suffix="", glb=0.25, rescale=1, tot_iter=4, view_batch=0)
    paths = world.run(tasks.fusion_two_ranks, str(tmp_path),
                      str(tmp_path / "two"))
    assert paths[0] == paths[1]
    one = fusion(dryrun.FusionLoader(str(tmp_path)), tmp_path / "one",
                 device="cpu", **kw)
    jax_out = j_fusion(make_loader(str(tmp_path), n, H, W), tmp_path / "jax",
                       multihost=False, **kw)
    xyz_2, rgb_2 = read_ply(paths[0])
    xyz_1, rgb_1 = read_ply(one)
    xyz_j, rgb_j = read_ply(jax_out)
    assert 0 < len(xyz_2) == len(xyz_1) == len(xyz_j)
    # the ranks' parts are merged rank by rank: compare as point sets
    o2, o1 = np.lexsort(xyz_2.T), np.lexsort(xyz_1.T)
    np.testing.assert_array_equal(xyz_2[o2], xyz_1[o1])
    np.testing.assert_array_equal(rgb_2[o2], rgb_1[o1])
    # one process each: the same views in the same order
    np.testing.assert_array_equal(rgb_1, rgb_j)
    np.testing.assert_allclose(xyz_1, xyz_j, rtol=1e-5, atol=1e-5)
    assert (tmp_path / "two" / "result.part1.ply").is_file()


def test_dryrun_on_two_ranks(world):
    """``dryrun_multiprocess`` at its CPU sizes: every check passes, the
    local plans differ, the ranks split the views and step eagerly, and
    the max and std aggregation's exchange was held on both ranks."""
    report = dryrun.dryrun_multiprocess(2, "cpu", world=world)
    assert report["train_rectified"]["plans_differ"]
    labels = []
    for case, aggregation in dryrun.FORWARD_CASES:
        labels.append(dryrun.forward_label(case, aggregation))
        f = report[f"forward_{labels[-1]}"]
        assert f["path"] == case
        assert sorted(sum(f["views"], [])) == list(range(8))
        assert f["eager_reason"] == "a CPU runner"
        assert all((e is None) == (aggregation == ("mean",))
                   for e in f["aggregate_err"])
    assert labels == ["exact", "rectified", "mixed",
                      "rectified_mean_max_std"]
    assert report["fusion"]["equal"]
