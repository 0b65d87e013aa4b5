"""The selective scan's backward on the CPU: the port's plain reverse
recurrence (``ref.selective_scan_bwd``, what the op's backward runs on a
CPU tensor) and the port's autograd ``ops.selective_scan`` against
``jax.vjp`` of the reference's ``ops.selective_scan`` (its Pallas forward
in interpret mode, its ``_ss_bwd``: ``jax.vjp`` of the oracle), all six
gradients within the scan's 1e-4; that the backward is linear in S and
never runs the plain forward ``ref.selective_scan``; and the dry-run's
charge of it, one ``selective_scan_bwd`` a Mamba layer at its bound.

Inputs come from ``torch_cases.scan_case`` (numpy, seeded).  The CUDA
kernel runs only on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as tss
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.api import build_model
from repro_torch.roofline import analysis as A
from repro_torch.roofline import costs
from torch_cases import scan_case
from torch_cases import one_torch_thread  # noqa: F401

TOL = 1e-4                       # the scan's bound, forward and gradients
NAMES = ("ddt", "dA", "dB", "dC", "dx", "dh0")

# (B, S, d, N, zero h0, ghT given): one step; a ragged S (no multiple of
# the kernel's 16-step chunks); N = 8 and 16; h0 zero and not; hT's
# cotangent given and None
CASES = [(2, 1, 24, 16, False, True),
         (2, 37, 24, 8, False, True),
         (1, 37, 40, 16, False, False),
         (2, 16, 32, 16, True, True),
         (1, 50, 16, 8, True, False),
         (3, 9, 20, 3, False, True)]


def _cotangents(B, S, d, N, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, d)).astype(np.float32),
            rng.normal(size=(B, d, N)).astype(np.float32))


def _reference(arrays, gy, ghT):
    _, vjp = jax.vjp(jops.selective_scan, *map(jnp.asarray, arrays))
    return [np.asarray(g) for g in vjp((jnp.asarray(gy), jnp.asarray(ghT)))]


def _case(B, S, d, N, zero_h0, seed=7):
    arrays = list(scan_case(B, S, d, N, seed=seed))
    if zero_h0:
        arrays[5] = np.zeros_like(arrays[5])
    return arrays


def _close(got, want):
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("B,S,d,N,zero_h0,with_ghT", CASES)
def test_plain_backward_matches_the_reference_vjp(B, S, d, N, zero_h0,
                                                  with_ghT):
    arrays = _case(B, S, d, N, zero_h0)
    gy, ghT = _cotangents(B, S, d, N)
    if not with_ghT:
        ghT = np.zeros_like(ghT)
    got = tref.selective_scan_bwd(
        *[torch.from_numpy(a) for a in arrays], torch.from_numpy(gy),
        torch.from_numpy(ghT) if with_ghT else None)
    _close([g.numpy() for g in got], _reference(arrays, gy, ghT))


@pytest.mark.parametrize("B,S,d,N,zero_h0,with_ghT", CASES)
def test_op_gradients_match_the_reference_vjp(B, S, d, N, zero_h0,
                                              with_ghT):
    """The autograd op on CPU tensors: the wrapper's plain backward, with
    hT's cotangent from autograd (materialised zeros when hT is unused)."""
    arrays = _case(B, S, d, N, zero_h0, seed=11)
    gy, ghT = _cotangents(B, S, d, N, seed=12)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, hT = tops.selective_scan(*ts)
    if with_ghT:
        loss = (y * torch.from_numpy(gy)).sum() + (
            hT * torch.from_numpy(ghT)).sum()
    else:
        loss = (y * torch.from_numpy(gy)).sum()
        ghT = np.zeros_like(ghT)
    got = torch.autograd.grad(loss, ts)
    _close([g.numpy() for g in got], _reference(arrays, gy, ghT))


@pytest.mark.parametrize("B,S,d,N,zero_h0,with_ghT", CASES)
def test_plain_backward_from_checkpoints_matches_the_reference_vjp(
        B, S, d, N, zero_h0, with_ghT):
    """The plain forward's chunk checkpoints (h before every CK-th step,
    bitwise the forward's h there), handed to the plain backward: bitwise
    the backward that makes its own, and within 1e-4 of ``jax.vjp`` of
    the reference."""
    arrays = _case(B, S, d, N, zero_h0, seed=13)
    gy, ghT = _cotangents(B, S, d, N, seed=14)
    ts = [torch.from_numpy(a) for a in arrays]
    y, hT, ckpt = tref.selective_scan(*ts, checkpoints=True)
    CK = tref.scan_checkpoint_steps(N)
    assert CK == tss.checkpoint_steps(N) == (16 if N <= 16 else 8)
    assert ckpt.shape == (B, -(-S // CK), d, N)
    plain_y, plain_h = tref.selective_scan(*ts)
    assert torch.equal(y, plain_y) and torch.equal(hT, plain_h)
    for k in range(ckpt.shape[1]):
        n = k * CK
        head = tref.selective_scan(ts[0][:, :n], ts[1], ts[2][:, :n],
                                   ts[3][:, :n], ts[4][:, :n], ts[5])[1]
        assert torch.equal(ckpt[:, k], head), k
    cot = (torch.from_numpy(gy), torch.from_numpy(ghT) if with_ghT else None)
    given = tref.selective_scan_bwd(*ts, *cot, ckpt)
    own = tref.selective_scan_bwd(*ts, *cot)
    assert all(torch.equal(g, o) for g, o in zip(given, own))
    if not with_ghT:
        ghT = np.zeros_like(ghT)
    _close([g.numpy() for g in given], _reference(arrays, gy, ghT))
    with pytest.raises(ValueError, match="checkpoints of shape"):
        tref.selective_scan_bwd(*ts, *cot, ckpt[:, :0])


def test_checkpoint_steps_by_state_size():
    assert [tref.scan_checkpoint_steps(n) for n in (1, 3, 8, 16, 17, 32, 33,
                                                    64)] == [16] * 4 + [8] * 2 \
        + [4] * 2


def test_op_hands_the_forwards_checkpoints_to_the_backward(monkeypatch):
    """The CPU autograd op: the forward makes the checkpoints (the plain
    checkpointing forward) and the backward takes exactly those, with no
    second forward (neither ``ref.selective_scan`` nor the plain
    backward's own checkpoint pass runs in it); under no_grad the forward
    makes none."""
    arrays = _case(2, 40, 16, 8, False)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    made, taken = [], []
    fwd, bwd = tref.selective_scan, tref.selective_scan_bwd

    def forward(*a, checkpoints=False):
        out = fwd(*a, checkpoints=checkpoints)
        made.append(out[2] if checkpoints else None)
        return out

    def backward(*a):
        taken.append(a[8])
        return bwd(*a)

    def refuse(*a, **k):
        raise AssertionError("the backward ran a forward pass")

    monkeypatch.setattr(tref, "selective_scan", forward)
    monkeypatch.setattr(tref, "selective_scan_bwd", backward)
    y, hT = tops.selective_scan(*ts)
    want = bwd(*[t.detach() for t in ts], 2 * y.detach(),
               torch.ones_like(hT))
    monkeypatch.setattr(tref, "selective_scan", refuse)
    monkeypatch.setattr(tref, "_scan_checkpoints", refuse)
    grads = torch.autograd.grad(y.square().sum() + hT.sum(), ts)
    assert len(made) == len(taken) == 1 and taken[0] is made[0]
    assert made[0].shape == (2, 3, 16, 8)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    monkeypatch.setattr(tref, "selective_scan", forward)
    with torch.no_grad():
        tops.selective_scan(*ts)
    assert made[-1] is None


def test_backward_is_linear_and_never_runs_the_plain_forward(monkeypatch):
    """The op's CPU backward does not call ``ref.selective_scan`` (the old
    quadratic recompute did), and its ops and bytes at 2S are twice
    those at S, up to the fixed cost."""
    def refuse(*a):
        raise AssertionError("the backward ran ref.selective_scan")

    arrays = _case(1, 24, 16, 8, False)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, hT = tops.selective_scan(*ts)
    monkeypatch.setattr(tref, "selective_scan", refuse)
    grads = torch.autograd.grad(y.square().sum() + hT.sum(), ts)
    assert all(torch.isfinite(g).all() for g in grads)

    def cost(S):
        t = [torch.from_numpy(a) for a in _case(1, S, 16, 8, False)]
        gy = torch.ones((1, S, 16))
        with costs.counting() as c:
            tref.selective_scan_bwd(*t, gy, None)
        return sum(r[0] for r in c.cost.by_op.values()), c.cost.bytes_accessed

    (n1, b1), (n2, b2), (n4, b4) = cost(64), cost(128), cost(256)
    assert 1.9 < n2 / n1 < 2.1 and 1.9 < n4 / n2 < 2.1
    assert 1.9 < b2 / b1 < 2.1 and 1.9 < b4 / b2 < 2.1


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    tss.selective_scan_bwd.launches = 0
    arrays = [torch.from_numpy(a) for a in _case(2, 5, 8, 4, False)]
    got = tss.selective_scan_bwd(*arrays, None, None)
    want = tref.selective_scan_bwd(*arrays, None, None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tss.selective_scan_bwd.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        tss.selective_scan_bwd(*[a.to("meta") for a in arrays], None, None)
    assert "selective_scan_bwd" in build.SIGNATURES


def test_meta_charge_equals_the_bound_formula():
    B, S, d, N = 2, 16, 64, 8
    f32 = dict(dtype=torch.float32, device="meta", requires_grad=True)
    args = (torch.empty((B, S, d), **f32), torch.empty((d, N), **f32),
            torch.empty((B, S, N), **f32), torch.empty((B, S, N), **f32),
            torch.empty((B, S, d), **f32), torch.empty((B, d, N), **f32))
    with costs.counting() as c:
        y, hT = tops.selective_scan(*args)
        grads = torch.autograd.grad(y.sum() + hT.sum(), args)
    assert [tuple(g.shape) for g in grads] == [tuple(a.shape) for a in args]
    assert c.cost.by_op["kernel.selective_scan_fwd"] == [
        1, A.scan_work(B, S, d, N)[1], A.scan_work(B, S, d, N)[0]]
    ck = costs.kernel("selective_scan_fwd", tss.selective_scan_fwd,
                      *[a.detach() for a in args], True)
    assert [tuple(t.shape) for t in ck] == [(B, S, d), (B, d, N),
                                           (B, 1, d, N)]
    assert all(t.device.type == "meta" for t in ck)
    nbytes, flops, exps = A.scan_bwd_work(B, S, d, N)
    assert c.cost.by_op["kernel.selective_scan_bwd"] == [1, flops, nbytes]
    assert nbytes == 4 * (5 * B * S * d + 4 * B * S * N + 2 * d * N
                          + 3 * B * d * N)
    assert exps == B * S * d * N
    ms, by, parts = A.scan_bound(nbytes, flops, exps)
    assert ms == max(parts.values()) and by in ("bytes", "operations")


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_falcon_train_step_charges_one_scan_backward_a_layer(device):
    """A Falcon-Mamba smoke train step traced on mesh (1, 1): one
    ``selective_scan_bwd`` a Mamba layer, each at its bound, the same on
    the meta device and on CPU tensors (where the plain backward runs)."""
    cfg = get_config("falcon-mamba-7b", smoke=True).replace(dtype="float32")
    B, S = 2, 24
    cost, _, _ = tsteps.trace_step(
        build_model(cfg), ShapeConfig("t", S, B, "train"),
        AbstractMesh((1, 1), ("data", "model")), device=device)
    nbytes, flops, _ = A.scan_bwd_work(B, S, cfg.d_inner, cfg.ssm_state)
    L = cfg.n_layers
    assert cost.by_op["kernel.selective_scan_bwd"] == [L, L * flops,
                                                       L * nbytes]
    assert cost.by_op["kernel.selective_scan_fwd"][0] == L
