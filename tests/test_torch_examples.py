"""The port's walk-through examples (``src/repro_torch/examples/``) against
the reference scripts (``examples/``) on the CPU.

(a) ``problems.make_lm_problem`` against ``benchmarks/common.py::
    make_lm_problem`` for the four examples' ``(n_clients, alpha)``: the
    params and the first three ``sample_batches`` draws bitwise, the eval
    loss within rtol 1e-6.
(b) ``wireless_scheduling_sim.main`` against the reference's ``main``, both
    at ROUNDS = 3: both printed tables parsed (the same policies in the
    same order, avg scheduled equal); the unrounded final loss and
    wall-clock within rtol 1e-5, participation bitwise; the best-policy
    line equal wherever the reference's gap to the second-best policy
    exceeds 1e-4 (at 3 rounds the ten final losses lie within 8e-4 of each
    other).
(c) each other example's ``main`` and the reference's at their own
    constants, with the engine entry points (``run_simulation``,
    ``run_hfl``, ``run_sweep``, ``run_gossip_sweep``, ``run_fog``) replaced
    on both sides by a recorder that returns the same stand-in logs: the
    same calls in the same order, every argument equal field by field
    (configs, wireless cells, mixing matrices, privacy grids, params and
    eval batches bitwise, the first draw of each call's batch source
    bitwise, so a shared or a fresh data stream shows), the loss function
    and the eval function within rtol 1e-5 on that draw, and the same
    printed text.
(d) each of those ``main``s run whole on the port's engines, cut to 1 round
    (the quickstart to 2, for its loss check) and ``private_fl`` to 4
    clients: it finishes and prints the reference's lines, in its formats
    and order. Engine parity for the same cells is held by
    ``test_torch_lm.py`` (quickstart, private_fl), ``test_torch_hfl.py``,
    ``test_torch_gossip.py`` and ``test_torch_fog.py``.
"""
import dataclasses
import importlib
import importlib.util
import inspect
import math
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.fl import decentralized as jdz  # noqa: E402
from repro.fl import runtime as jrt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.examples import problems  # noqa: E402
from repro_torch.fl import decentralized as tdz  # noqa: E402
from repro_torch.fl import runtime as trt  # noqa: E402
from repro_torch.examples import wireless_scheduling_sim as wss  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "private_fl", "hierarchical_fl",
            "decentralized_gossip", "fog_hybrid", "wireless_scheduling_sim")
STUDY_ROUNDS, STUDY_RTOL, BEST_GAP = 3, 1e-5, 1e-4
# (d): rounds and, for private_fl's secure aggregation, clients cut so the
# whole runs stay short on the CPU; the quickstart needs 2 rounds for its
# ``loss falls`` check
CUT = {"quickstart": {"ROUNDS": 2}, "private_fl": {"ROUNDS": 1, "N": 4}}
ENGINES = ((jrt, trt, ("run_simulation", "run_hfl", "run_sweep")),
           (jdz, tdz, ("run_gossip_sweep", "run_fog")))
CALL_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch ops of this file on one thread: the test run spreads files over
    several processes on one host, where many small ops stall on
    oversubscribed intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_reference", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# (a) the shared LM problem
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_clients, alpha",
                         [(20, 0.1), (21, 0.3), (16, 0.5), (28, 0.5)])
def test_lm_problem_matches_reference(n_clients, alpha):
    jp, jloss, jsample, jeval = jcommon.make_lm_problem(n_clients, alpha)
    tp, tloss, tsample, teval = problems.make_lm_problem(n_clients, alpha,
                                                         device="cpu")
    assert list(tp) == list(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    for t in range(3):
        jb, tb = jsample(t, n_clients), tsample(t, n_clients)
        assert list(tb) == list(jb)
        for k in jb:
            assert isinstance(tb[k], np.ndarray)
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]),
                                          err_msg=f"draw {t} {k}")
    for k, v in jeval.eval_batch.items():
        np.testing.assert_array_equal(teval.eval_batch[k].numpy(),
                                      np.asarray(v))
    np.testing.assert_allclose(teval(tp), jeval(jp), rtol=1e-6)
    np.testing.assert_allclose(
        float(tloss(tp, teval.eval_batch)[0]), jeval(jp), rtol=1e-6)


# ---------------------------------------------------------------------------
# (b) the scheduling study
# ---------------------------------------------------------------------------
_ROW = re.compile(r"^(\S+) +(-?\d+\.\d{4}) +(\d+\.\d)s +(\d+\.\d)$")
_BEST = re.compile(r"^best final loss: (\S+) \((-?\d+\.\d{4})\)$")


def _table(out: str):
    """The study's printed table: header, ``{policy: (loss, wall, sched)}``
    in printed order, and the best-policy line's (policy, loss)."""
    lines = out.splitlines()
    assert lines[0].split() == ["policy", "final", "loss", "wall-clock",
                                "avg", "sched"]
    rows = {}
    for line in lines[1:]:
        if not line:
            break
        m = _ROW.match(line)
        assert m, line
        rows[m[1]] = tuple(float(x) for x in m.groups()[1:])
    best = _BEST.match(lines[-1])
    assert best and lines[-2] == "", lines[-2:]
    return rows, (best[1], float(best[2]))


def test_scheduling_study_matches_reference(monkeypatch, capsys):
    ref = _reference("wireless_scheduling_sim")
    monkeypatch.setattr(ref, "ROUNDS", STUDY_ROUNDS)
    monkeypatch.setattr(wss, "ROUNDS", STUDY_ROUNDS)
    swept = []
    run_sweep = ref.rt.run_sweep
    monkeypatch.setattr(ref.rt, "run_sweep", lambda *a, **kw: swept.append(
        run_sweep(*a, **kw)) or swept[-1])
    ref.main()
    want_out = capsys.readouterr().out
    got = wss.main([], device="cpu")
    got_out = capsys.readouterr().out
    want = swept[0]

    want_rows, want_best = _table(want_out)
    got_rows, got_best = _table(got_out)
    assert list(got_rows) == list(want_rows) == list(want) == list(got)
    for pol, (loss, wall, sched) in want_rows.items():
        g_loss, g_wall, g_sched = got_rows[pol]
        assert g_sched == sched, pol
        assert abs(g_loss - loss) <= 1e-4 + 1e-9, pol   # printed to 4 places
        assert abs(g_wall - wall) <= 0.1 + 1e-9, pol    # and to 1
    finals = {}
    for pol, w in want.items():
        g = got[pol]
        np.testing.assert_array_equal(g.participation,
                                      np.asarray(w.participation),
                                      err_msg=pol)
        np.testing.assert_array_equal(g.n_scheduled,
                                      np.asarray(w.n_scheduled), err_msg=pol)
        np.testing.assert_allclose(g.loss[0, -1], float(w.loss[0, -1]),
                                   rtol=STUDY_RTOL, err_msg=pol)
        np.testing.assert_allclose(g.latency_s[0, -1],
                                   float(w.latency_s[0, -1]),
                                   rtol=STUDY_RTOL, err_msg=pol)
        finals[pol] = float(w.loss[0, -1])
    first, second = sorted(finals.values())[:2]
    assert want_best[0] == min(finals, key=finals.get)
    if second - first > BEST_GAP:
        assert got_best[0] == want_best[0]


# ---------------------------------------------------------------------------
# (c) the other examples' engine calls, at their own constants
# ---------------------------------------------------------------------------
def _stand_in_logs(name, args, i):
    """Logs for the ``i``-th engine call, the same on both sides: every
    printed field, numbers that differ by call and by round."""
    cfg = args["cfg"]
    r = cfg.rounds
    if name in ("run_simulation", "run_hfl"):
        dp = cfg.privacy in ("dp", "secagg_dp")
        return [SimpleNamespace(
            round=t, latency_s=90.0 * (t + 1) / (i + 1), comm_s=30.0 * t,
            loss=4.0 - 0.01 * t - 0.1 * i, n_scheduled=cfg.n_devices - i,
            uplink_bits=1.5e6 * (t + 1), mask_bits=2.5e3 * i,
            epsilon=0.5 * (t + 1) if dp else math.inf, delta=1e-5)
            for t in range(r)]
    series = {k: 2.0 + 0.25 * i + j + np.arange(8 * r).reshape(8, r) / 7.0
              for j, k in enumerate(("loss", "epsilon", "consensus_err",
                                     "latency_s", "n_edges",
                                     "backhaul_bits"))}
    if name == "run_sweep":
        return {(pol, p): SimpleNamespace(**series)
                for pol in args["policies"] or [cfg.policy]
                for p in args["privacies"] or [cfg.privacy]}
    if name == "run_fog":
        return None, SimpleNamespace(**{k: v[0] for k, v in series.items()})
    return SimpleNamespace(**series)


def _recorder(name, real, calls, to_side):
    """``real``'s stand-in: binds the arguments by name (defaults applied,
    ``device`` dropped), draws once from the batch source, evaluates the
    loss (and eval) function on that draw's first client step, records
    ``(name, arguments, numbers)`` and returns the stand-in logs."""
    sig = inspect.signature(real)

    def engine(*a, **kw):
        bound = sig.bind(*a, **kw)
        bound.apply_defaults()
        args = dict(bound.arguments)
        args.pop("device", None)
        cfg, params = args["cfg"], args["init_params"]
        if "batches" in args:
            one = {k: np.asarray(v)[0, 0, 0]
                   for k, v in args["batches"].items()}
        else:
            n = getattr(cfg, "n_devices", None) or cfg.n_nodes
            draw = args["sample_client_batches"](0, n)
            args["sample_client_batches"] = {k: np.asarray(v)
                                             for k, v in draw.items()}
            one = {k: v[0, 0]
                   for k, v in args["sample_client_batches"].items()}
        numbers = {"loss_fn": float(args.pop("loss_fn")(
            params, {k: to_side(v) for k, v in one.items()})[0])}
        if args.get("eval_fn") is not None:
            numbers["eval_fn"] = float(args["eval_fn"](params))
            args["eval_fn"] = args["eval_fn"].eval_batch
        if any(isinstance(v, dict) for v in params.values()):
            args["init_params"] = convert.lm_params_from_jax(params)
        calls.append((name, args, numbers))
        return _stand_in_logs(name, args, len(calls) - 1)
    return engine


def _array(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return np.asarray(x)
    return None


def _assert_same(got, want, path):
    """``got`` (the port's) equals ``want`` (the reference's): dataclasses
    and NamedTuples field by field, arrays and tensors in dtype, shape and
    every bit, everything else by ``==``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(want) or hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__, path
        names = ([f.name for f in dataclasses.fields(want)]
                 if dataclasses.is_dataclass(want) else want._fields)
        for f in names:
            _assert_same(getattr(got, f), getattr(want, f), f"{path}.{f}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif _array(want) is not None:
        g, w = _array(got), _array(want)
        assert g is not None and (g.dtype, g.shape) == (w.dtype, w.shape), (
            path, got, want)
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(set(EXAMPLES) - {
    "wireless_scheduling_sim"}))
def test_example_engine_calls_match_reference(name, monkeypatch, capsys):
    calls = {"ref": [], "port": []}
    for jmod, tmod, names in ENGINES:
        for fn in names:
            monkeypatch.setattr(jmod, fn, _recorder(
                fn, getattr(jmod, fn), calls["ref"], jnp.asarray))
            monkeypatch.setattr(tmod, fn, _recorder(
                fn, getattr(tmod, fn), calls["port"], torch.as_tensor))
    _reference(name).main()
    want_out = capsys.readouterr().out
    importlib.import_module(f"repro_torch.examples.{name}").main(
        [], device="cpu")
    assert capsys.readouterr().out == want_out

    want, got = calls["ref"], calls["port"]
    assert want and [c[0] for c in got] == [c[0] for c in want]
    for i, ((fn, targs, tnum), (_, jargs, jnum)) in enumerate(zip(got,
                                                                  want)):
        _assert_same(targs, jargs, f"call {i} {fn}")
        assert sorted(tnum) == sorted(jnum)
        for k in jnum:
            np.testing.assert_allclose(tnum[k], jnum[k], rtol=CALL_RTOL,
                                       err_msg=f"call {i} {fn} {k}")


# ---------------------------------------------------------------------------
# (d) the other examples run whole, cut to size
# ---------------------------------------------------------------------------
_F = r"-?\d+\.\d"            # a fixed-point number's head
_E = r"-?\d\.\d{2}e[+-]\d+"  # %.2e
_FORMATS = {
    "quickstart": [
        r"model: {name}  params~{params}",
        *[rf"round +{t}  wall-clock +{_F}s  \(comm +{_F}s\)  loss {_F}{{4}}"
          rf"  scheduled \d+  uplink {_E}b" for t in range(2)],
        r"quickstart OK"],
    "private_fl": [
        r"model: {name}  params~{params}",
        rf"     none: loss {_F}{{4}}  eps=   inf \(no DP\)  uplink {_E}b "
        rf"\(masks {_E}b\)",
        rf"   secagg: loss {_F}{{4}}  eps=   inf \(no DP\)  uplink {_E}b "
        rf"\(masks {_E}b\)",
        rf"secagg_dp: loss {_F}{{4}}  eps= *{_F}{{2}} \(delta=1e-05\)  "
        rf"uplink {_E}b \(masks {_E}b\)",
        r"", r"privacy-utility frontier \(dp, clip=1\.0\):",
        *[rf"  sigma={s}: loss {_F}{{4}}  eps= *{_F}{{2}}"
          for s in ("0.3", "1.0", "3.0")],
        r"private_fl OK"],
    "hierarchical_fl": [
        rf"flat FL   : loss {_F}{{4}} -> {_F}{{4}}  wall-clock +{_F}s",
        *[rf"HFL \(H={h}\): loss {_F}{{4}} -> {_F}{{4}}  wall-clock +{_F}s"
          rf"  \({_F}x faster than flat FL\)" for h in (2, 4, 6)]],
    "decentralized_gossip": [
        r"3 topologies, 1 trace\(s\)", r"",
        *[rf"{re.escape(g)} +spectral gap \d\.\d{{3}}  final loss {_F}{{4}}"
          rf"  drift {_F}{{4}}  wall clock {_F}s  \(\d+ D2D edges\)"
          for g in ("ring", "torus 4x4", "erdos-renyi(0.4)")]],
    "fog_hybrid": [
        r"28 devices, 7 clusters, SBS sync every 4 rounds",
        r"  k  final-loss  wall-clock  backhaul-bits  drift",
        *[rf"  {k} +{_F}{{4}} +{_F}s +{_E} +{_E}" for k in (1, 2, 4)]],
}


@pytest.mark.parametrize("name", sorted(_FORMATS))
def test_example_prints_reference_lines(name, monkeypatch, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    for const, v in CUT.get(name, {"ROUNDS": 1}).items():
        monkeypatch.setattr(mod, const, v)
    if name == "private_fl":
        monkeypatch.setattr(mod.qs, "N", mod.N)
    if name == "decentralized_gossip":
        from repro_torch.fl import runtime as trt
        monkeypatch.setattr(trt, "_ENGINE_CACHE", {})
    mod.main([], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    cfg = jconfigs.get_config("gemma-2b").reduced()
    pats = [p.replace("{name}", re.escape(cfg.name)).replace(
        "{params}", f"{cfg.param_count():,}") for p in _FORMATS[name]]
    assert len(lines) == len(pats), lines
    for line, pat in zip(lines, pats):
        assert re.fullmatch(pat, line), (pat, line)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
