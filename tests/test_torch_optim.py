"""The port's optimizers, schedules and checkpoints (``repro_torch.optim``,
``repro_torch.checkpoint``) against the JAX package, on the CPU.

(a) ``sgd``, ``momentum_sgd`` and ``adamw`` over 20 steps of numpy-made
    gradients on a tree of three leaves, with float32 and bf16 moments:
    params and moments within rtol 1e-6 / atol 1e-7 (float32 moments;
    XLA contracts the moment updates into fused multiply-adds, which moves
    a result by an ulp), bf16 moments within one bf16 step; the step
    counters equal.
(b) ``cosine_schedule``, ``wsd_schedule`` and ``get_schedule`` at every step
    0..N+4: bitwise the reference's op-by-op values (its ``cos`` is
    ``cosf``, its ``exp`` and ``log`` XLA's polynomials), and within 8 ulp
    (rtol 1e-6) of its jitted values, where XLA fuses the divisions.
(c) Checkpoints: a state round-trips bitwise (bf16 through float32), a
    checkpoint written by either package loads in the other, and
    ``latest_step``.
(d) The port's copies of the reference's ``tests/test_optim_data_ckpt.py``
    assertions (the quadratic, weight decay, the schedules' shapes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

SHAPES = {"a": (7, 5), "b/c": (11,), "b/d": (2, 3, 4)}
STEPS = 20
F32 = dict(rtol=1e-6, atol=1e-7)


def _nested(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


# ---------------------------------------------------------------------------
# (a) optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_optimizer_matches_reference(kind, state_dtype):
    params, grads = _trees()
    jp = _nested({k: jnp.asarray(v) for k, v in params.items()})
    js = joptim.init_opt_state(jp, kind, jnp.dtype(state_dtype))
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ts = toptim.init_opt_state(tp, kind, state_dtype)
    jfn, tfn = joptim.apply_updates(kind), toptim.apply_updates(kind)
    lrs = np.linspace(0.01, 0.1, STEPS).astype(np.float32)
    for g, lr in zip(grads, lrs):
        jp, js = jfn(jp, _nested({k: jnp.asarray(v) for k, v in g.items()}),
                     js, jnp.float32(lr))
        tp, ts = tfn(tp, {k: torch.as_tensor(v) for k, v in g.items()}, ts,
                     torch.tensor(lr))
    assert int(ts.step) == int(js.step) == STEPS
    assert ts.step.dtype == torch.int32
    want = convert.lm_params_from_jax(jp)
    for k in SHAPES:
        torch.testing.assert_close(tp[k], want[k], **F32)
    for jt, tt in ((js.m, ts.m), (js.v, ts.v)):
        assert (jt is None) == (tt is None)
        if tt is None:
            continue
        want = convert.lm_params_from_jax(jt)
        for k in SHAPES:
            assert tt[k].dtype == getattr(torch, state_dtype)
            tol = F32 if state_dtype == "float32" else dict(rtol=8e-3,
                                                           atol=1e-6)
            torch.testing.assert_close(tt[k].float(), want[k].float(), **tol)


def test_optimizers_leave_their_arguments_as_they_were():
    params, grads = _trees(1)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    ts = toptim.init_opt_state(tp, "adamw")
    g = {k: torch.as_tensor(v) for k, v in grads[0].items()}
    before = {k: v.clone() for k, v in tp.items()}
    toptim.adamw(tp, g, ts, torch.tensor(0.1))
    for k in tp:
        assert torch.equal(tp[k], before[k])
        assert not ts.m[k].any() and not ts.v[k].any()
    assert int(ts.step) == 0
    with pytest.raises(ValueError):
        toptim.init_opt_state(tp, "lion")


# ---------------------------------------------------------------------------
# (b) schedules
# ---------------------------------------------------------------------------
SCHEDULES = [("cosine", 6), ("cosine", 30), ("cosine", 1000), ("wsd", 6),
             ("wsd", 30), ("wsd", 1000)]


@pytest.mark.parametrize("name,total", SCHEDULES)
@pytest.mark.parametrize("base_lr", [3e-4, 1e-3, 2.0])
def test_schedule_matches_reference(name, total, base_lr):
    jf = jsched.get_schedule(name, base_lr, total)
    tf = tsched.get_schedule(name, base_lr, total)
    steps = np.arange(total + 5, dtype=np.int32)
    step_list = steps if total < 100 else steps[::7]
    got = np.array([tf(torch.tensor(s)).numpy() for s in step_list])
    eager = np.array([np.asarray(jf(jnp.asarray(s))) for s in step_list])
    np.testing.assert_array_equal(got, eager)
    jitted = jax.jit(jf)
    np.testing.assert_allclose(
        got, np.array([np.asarray(jitted(jnp.asarray(s)))
                       for s in step_list]), rtol=1e-6)
    assert got.dtype == np.float32
    if name == "cosine":
        assert got[0] == 0.0  # warm-up from lr 0


@pytest.mark.parametrize("fn,args", [
    ("cosine_schedule", (1.0, 10, 100)), ("cosine_schedule", (3e-3, 1, 30)),
    ("wsd_schedule", (1.0, 10, 60, 30)), ("wsd_schedule", (2e-3, 3, 20, 5))])
def test_schedule_functions_match_reference(fn, args):
    for s in range(0, 120, 3):
        np.testing.assert_array_equal(
            getattr(tsched, fn)(s, *args).numpy(),
            np.asarray(getattr(jsched, fn)(s, *args)))


# ---------------------------------------------------------------------------
# (c) checkpoints
# ---------------------------------------------------------------------------
def _state(seed=2, dtype=torch.float32):
    params, _ = _trees(seed)
    tp = {k: torch.as_tensor(v).to(dtype) for k, v in params.items()}
    opt = toptim.init_opt_state(tp, "adamw", torch.bfloat16)
    opt = toptim.OptState(torch.tensor(3, dtype=torch.int32),
                          {k: v + 0.5 for k, v in opt.m.items()},
                          {k: v + 0.25 for k, v in opt.v.items()})
    return {"params": tp, "opt": opt,
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_round_trip(tmp_path):
    state = _state(dtype=torch.bfloat16)
    path = tckpt.save_checkpoint(str(tmp_path), 7, state)
    assert path.endswith("ckpt_00000007.npz")
    with np.load(path) as data:
        assert sorted(data) == sorted(
            ["opt/m/a", "opt/m/b/c", "opt/m/b/d", "opt/step", "opt/v/a",
             "opt/v/b/c", "opt/v/b/d", "params/a", "params/b/c",
             "params/b/d", "step"])
        assert data["params/a"].dtype == np.float32  # bf16 stored as f32
    back = tckpt.load_checkpoint(str(tmp_path), 7, state)
    assert back["opt"].step.dtype == torch.int32 and int(back["step"]) == 7
    for tree in ("params",):
        for k, v in state[tree].items():
            assert back[tree][k].dtype == v.dtype
            assert torch.equal(back[tree][k], v)
    for a, b in zip(back["opt"], state["opt"]):
        if isinstance(b, dict):
            for k in b:
                assert torch.equal(a[k], b[k])
    bad = dict(state, step=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="step"):
        tckpt.load_checkpoint(str(tmp_path), 7, bad)


def test_checkpoints_cross_load_both_ways(tmp_path):
    state = _state()
    # port -> reference, into the reference's nested structure
    tckpt.save_checkpoint(str(tmp_path / "t"), 5, state)
    like = {"params": _nested({k: jnp.zeros(v.shape)
                               for k, v in state["params"].items()}),
            "opt": joptim.OptState(
                jnp.zeros((), jnp.int32),
                _nested({k: jnp.zeros(v.shape, jnp.bfloat16)
                         for k, v in state["opt"].m.items()}),
                _nested({k: jnp.zeros(v.shape, jnp.bfloat16)
                         for k, v in state["opt"].v.items()})),
            "step": jnp.zeros((), jnp.int32)}
    got = jckpt.load_checkpoint(str(tmp_path / "t"), 5, like)
    assert int(got["step"]) == 7 and int(got["opt"].step) == 3
    for k, v in convert.lm_params_from_jax(got["params"]).items():
        assert torch.equal(v, state["params"][k])
    for k, v in convert.lm_params_from_jax(got["opt"].m).items():
        assert torch.equal(v, state["opt"].m[k])
    # reference -> port
    jckpt.save_checkpoint(str(tmp_path / "j"), 9, got)
    back = tckpt.load_checkpoint(str(tmp_path / "j"), 9, state)
    for k, v in state["params"].items():
        assert torch.equal(back["params"][k], v)
    for k, v in state["opt"].v.items():
        assert torch.equal(back["opt"].v[k], v)
    assert int(back["opt"].step) == 3


def test_latest_step(tmp_path):
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    assert tckpt.latest_step(str(tmp_path)) is None
    for s in (3, 12, 7):
        tckpt.save_checkpoint(str(tmp_path), s, {"w": torch.ones(2)})
    (tmp_path / "ckpt_x.npz").write_bytes(b"")
    assert tckpt.latest_step(str(tmp_path)) == 12
    assert jckpt.latest_step(str(tmp_path)) == 12


# ---------------------------------------------------------------------------
# (d) the reference's own assertions, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,opt", [("sgd", toptim.sgd),
                                      ("momentum", toptim.momentum_sgd),
                                      ("adamw", toptim.adamw)])
def test_optimizers_minimize_quadratic(kind, opt):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = toptim.init_opt_state(params, kind)
    lr = 0.1 if kind != "adamw" else 0.05
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state = opt(params, g, state, lr)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_adamw_weight_decay():
    params = {"w": torch.ones(4) * 10}
    state = toptim.init_opt_state(params, "adamw")
    p2, _ = toptim.adamw(params, {"w": torch.zeros(4)}, state, 0.1,
                         weight_decay=0.1)
    assert float(p2["w"][0]) < 10.0


def test_cosine_schedule_shape():
    lrs = [float(tsched.cosine_schedule(s, 1.0, 10, 100)) for s in range(100)]
    assert lrs[0] < lrs[9]           # warmup
    assert lrs[10] == pytest.approx(1.0, abs=0.01)
    assert lrs[-1] < 0.2             # decayed


def test_wsd_schedule_plateau():
    lrs = [float(tsched.wsd_schedule(s, 1.0, 10, 60, 30)) for s in range(100)]
    assert lrs[5] < 1.0
    plateau = lrs[15:65]
    assert max(plateau) == pytest.approx(min(plateau))  # stable is flat
    assert lrs[-1] < 0.1
