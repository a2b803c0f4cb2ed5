"""PyTorch port vs the JAX package: the pose-graph smoother
(`opt/pose_graph.py`). Every case of tests/test_pose_graph.py but the
sharded one runs on the port with the JAX test's own assertions, and the
JAX function on the same numpy inputs: poses and residual norms within
1e-5, Jacobians within 1e-5 of ``jax.jacfwd``'s (the port takes them in
reverse mode), the block-tridiagonal solve within the JAX test's 2e-4 of a
dense float64 solve and 1e-5 of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.opt import pose_graph as jpg
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.opt import pose_graph as tpg
from pointcloudprocessor_tpu_torch.utils import interop

from test_pose_graph import _drifted_odometry, _perturb, _random_trajectory

CPU = "cpu"
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: a torch thread pool under the tier-1 run's xdist
    workers slows every worker (tests/test_torch_hpr_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x: jse3.SE3) -> tse3.SE3:
    return interop.pose(np.asarray(x.q), np.asarray(x.t), CPU)


def _ate(a: tse3.SE3, b: tse3.SE3) -> float:
    return float(torch.sqrt(torch.mean(torch.sum((a.t - b.t) ** 2, dim=-1))))


def _same_result(got: tpg.PoseGraphResult, want: jpg.PoseGraphResult):
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t), atol=TOL)
    np.testing.assert_allclose(got.poses.q.numpy(), np.asarray(want.poses.q), atol=TOL)
    np.testing.assert_allclose(float(got.residual_norm), float(want.residual_norm), atol=TOL)
    np.testing.assert_allclose(float(got.initial_residual_norm),
                               float(want.initial_residual_norm), atol=TOL)
    assert got.iterations == int(want.iterations)


def test_block_tridiagonal_matches_dense_and_jax():
    rng = np.random.default_rng(0)
    k = 7
    diag = rng.normal(size=(k, 6, 6)).astype(np.float32)
    diag = diag @ diag.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    upper = 0.1 * rng.normal(size=(k - 1, 6, 6)).astype(np.float32)
    rhs = rng.normal(size=(k, 6)).astype(np.float32)
    dense = np.zeros((6 * k, 6 * k), np.float64)
    for i in range(k):
        dense[6 * i: 6 * i + 6, 6 * i: 6 * i + 6] = diag[i]
    for i in range(k - 1):
        dense[6 * i: 6 * i + 6, 6 * i + 6: 6 * i + 12] = upper[i]
        dense[6 * i + 6: 6 * i + 12, 6 * i: 6 * i + 6] = upper[i].T
    expect = np.linalg.solve(dense, rhs.reshape(-1)).reshape(k, 6)

    got = tpg.solve_block_tridiagonal(*map(torch.from_numpy, (diag, upper, rhs))).numpy()
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)
    want = jpg.solve_block_tridiagonal(jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    one = tpg.solve_block_tridiagonal(*(torch.from_numpy(a[:1]) for a in (diag, upper, rhs)))
    np.testing.assert_allclose(one.numpy()[0], np.linalg.solve(diag[0], rhs[0]), rtol=1e-5)


def test_recovers_drifted_trajectory():
    rng = np.random.default_rng(1)
    gt = _random_trajectory(rng, k=24)
    odom, noisy_rel = _drifted_odometry(rng, gt)
    meas = _perturb(rng, gt, 0.01, 0.002)
    res = tpg.optimize(_t(odom), _t(noisy_rel), _t(meas), abs_weight=torch.ones(24),
                       odo_weight=1.0, iterations=8)
    gt_t, odom_t = _t(gt), _t(odom)
    assert res.residual_norm < res.initial_residual_norm
    assert _ate(res.poses, gt_t) < 0.5 * _ate(odom_t, gt_t)
    assert _ate(res.poses, gt_t) < 0.03
    _same_result(res, jpg.optimize(odom, noisy_rel, meas, abs_weight=jnp.ones(24),
                                   odo_weight=1.0, iterations=8))


def test_masked_nodes_ride_the_chain():
    """Nodes whose refinement 'failed' (weight 0) follow the odometry."""
    rng = np.random.default_rng(2)
    gt = _random_trajectory(rng, k=16)
    odom, noisy_rel = _drifted_odometry(rng, gt, trans_sigma=0.02)
    meas = _perturb(rng, gt, 0.005, 0.001)
    w = np.ones(16, np.float32)
    w[5:11] = 0.0
    res = tpg.optimize(_t(odom), _t(noisy_rel), _t(meas), abs_weight=torch.from_numpy(w),
                       odo_weight=5.0)
    gt_t, odom_t = _t(gt), _t(odom)
    assert _ate(res.poses, gt_t) < _ate(odom_t, gt_t)
    masked = tse3.SE3(res.poses.q[5:11], res.poses.t[5:11])
    assert _ate(masked, tse3.SE3(gt_t.q[5:11], gt_t.t[5:11])) < _ate(
        tse3.SE3(odom_t.q[5:11], odom_t.t[5:11]), tse3.SE3(gt_t.q[5:11], gt_t.t[5:11]))
    _same_result(res, jpg.optimize(odom, noisy_rel, meas, abs_weight=jnp.asarray(w),
                                   odo_weight=5.0))


def test_smooth_refined_trajectory_wrapper():
    rng = np.random.default_rng(3)
    gt = _random_trajectory(rng, k=12)
    odom, _ = _drifted_odometry(rng, gt)
    target = _perturb(rng, gt, 0.005, 0.001)
    corr = jse3.compose(jse3.inverse(odom), target)
    converged = np.ones(12, bool)
    converged[4] = False  # one refinement that did not converge rides the chain
    res = tpg.smooth_refined_trajectory(_t(odom), _t(corr),
                                        converged=torch.from_numpy(converged), odo_weight=1.0)
    assert _ate(res.poses, _t(gt)) < _ate(_t(odom), _t(gt))
    _same_result(res, jpg.smooth_refined_trajectory(odom, corr, converged=jnp.asarray(converged),
                                                    odo_weight=1.0))


def test_consistent_graph_is_fixed_point():
    """Exactly consistent measurements (zero residuals) give no NaN and
    leave the trajectory where it was."""
    q = np.tile(np.asarray([[1.0, 0, 0, 0]], np.float32), (4, 1))
    t = np.asarray([[0, 0, 0], [0.5, 0, 0], [1, 0, 0], [1.5, 0, 0]], np.float32)
    res = tpg.smooth_refined_trajectory(interop.pose(q, t, CPU),
                                        tse3.identity(CPU, batch_shape=(4,)),
                                        converged=torch.ones(4, dtype=torch.bool))
    assert torch.isfinite(res.poses.t).all() and torch.isfinite(res.poses.q).all()
    np.testing.assert_allclose(res.poses.t.numpy(), t, atol=1e-5)
    _same_result(res, jpg.smooth_refined_trajectory(
        jse3.SE3(jnp.asarray(q), jnp.asarray(t)), jse3.identity(batch_shape=(4,)),
        converged=jnp.ones(4, bool)))


def test_jacobians_match_jax_jacfwd():
    """The unary and between Jacobians at zero against ``jax.jacfwd`` of the
    JAX residuals on the same poses, and finite at zero residuals."""
    rng = np.random.default_rng(5)
    k = 6
    poses = _random_trajectory(rng, k=k)
    meas = _perturb(rng, poses, 0.02, 0.01)
    odo = _perturb(rng, jpg.relative_measurements(poses), 0.02, 0.01)
    ti, tj = jse3.SE3(poses.q[:-1], poses.t[:-1]), jse3.SE3(poses.q[1:], poses.t[1:])
    zero = jnp.zeros(6, jnp.float32)

    @jax.jit
    def jax_jacobians(poses, meas, ti, tj, odo):
        unary = jax.vmap(lambda q, t, mq, mt: jax.jacfwd(jpg._unary_residual)(
            zero, jse3.SE3(q, t), jse3.SE3(mq, mt)))(poses.q, poses.t, meas.q, meas.t)
        between = [jax.vmap(lambda qi, tti, qj, ttj, zq, zt: jax.jacfwd(
            jpg._between_residual, argnums=argnum)(
            zero, zero, jse3.SE3(qi, tti), jse3.SE3(qj, ttj), jse3.SE3(zq, zt)))(
            ti.q, ti.t, tj.q, tj.t, odo.q, odo.t) for argnum in (0, 1)]
        return unary, *between

    want_u, want_i, want_j = jax_jacobians(poses, meas, ti, tj, odo)

    def unary(T, M):
        return tpg._linearize(lambda xi: tpg._unary_residual(xi, T, M), 1, k, torch.float32,
                              CPU)[1][0]

    np.testing.assert_allclose(unary(_t(poses), _t(meas)).numpy(), np.asarray(want_u), atol=TOL)
    Ti, Tj, Z = _t(ti), _t(tj), _t(odo)
    _, (got_i, got_j) = tpg._linearize(
        lambda xi_i, xi_j: tpg._between_residual(xi_i, xi_j, Ti, Tj, Z), 2, k - 1,
        torch.float32, CPU)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=TOL)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), atol=TOL)
    at_zero = unary(_t(poses), _t(poses))
    assert torch.isfinite(at_zero).all()
    np.testing.assert_allclose(at_zero.numpy(), np.broadcast_to(np.eye(6), (k, 6, 6)), atol=1e-5)
