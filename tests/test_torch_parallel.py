"""A16, sharding: gpy_tpu_torch.parallel against gpy_tpu.parallel.

The port's side runs in one group of 4 gloo ranks on the CPU, spawned once
for the module: each case sends its name and numpy inputs to every rank
and gets every rank's result back (a rank that raises fails the case). The
reference's side runs in the pytest process on make_mesh(4) of the 8
virtual CPU devices (tests/conftest.py), each sharded function under one
jax.jit, while the ranks compute. Both at float64, from the same numpy
arrays; raw parameters cross through util/convert.py.

Held: the port's sharded values and gradients against the reference's
sharded functions (rel 1e-9 on values, rtol 1e-6 / atol 1e-8 on
gradients, the reference's own limits) and against the port's serial
model, with padding and on the 2 x 2 ("dcn", "ici") mesh; HMC and parallel
restarts over the mesh; the collectives each sharded program makes;
distributed_initialize without and with a launcher environment.

Top-level imports stay numpy, torch and pytest: each spawned rank imports
this module again.
"""
import datetime
import socket
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT_S = 60
VAL_REL = 1e-9                    # port sharded vs reference sharded
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-8
SERIAL_REL = 1e-10                # port sharded vs port serial


# --- the ranks ----------------------------------------------------------------

def _rank_main(rank, init_file, inq, outq):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        # the package's import and the meshes' groups, while the first
        # case's reference side runs in the pytest process
        _mesh("1d"), _mesh("2d")
        while True:
            msg = inq.get()
            if msg is None:
                break
            name, payload = msg
            try:
                outq.put((rank, True, _CASES[name](payload)))
            except Exception:  # noqa: BLE001 -- reported to the test, which fails
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class _Ranks:
    def __init__(self, inqs, outq):
        self.inqs, self.outq = inqs, outq

    def submit(self, name, payload):
        for q in self.inqs:
            q.put((name, payload))

    def result(self):
        """Every rank's result, in rank order; raises if one raised."""
        got = {}
        for _ in range(WORLD):
            rank, ok, out = self.outq.get(timeout=TIMEOUT_S)
            got[rank] = (ok, out)
        failed = [f"rank {r}:\n{out}" for r, (ok, out) in sorted(got.items()) if not ok]
        if failed:
            pytest.fail("\n".join(failed))
        return [got[r][1] for r in range(WORLD)]

    def run(self, name, payload):
        self.submit(name, payload)
        return self.result()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    init = tmp_path_factory.mktemp("gloo") / "rendezvous"
    inqs = [ctx.Queue() for _ in range(WORLD)]
    outq = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, str(init), inqs[r], outq), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    yield _Ranks(inqs, outq)
    for q in inqs:
        q.put(None)
    for p in procs:
        p.join(TIMEOUT_S)
        if p.is_alive():
            p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


# --- port side (runs in every rank) --------------------------------------------

_MESHES = {}


def _mesh(kind):
    from gpy_tpu_torch.parallel import make_mesh, make_mesh_2d

    if kind not in _MESHES:
        _MESHES[kind] = (make_mesh(device="cpu") if kind == "1d"
                         else make_mesh_2d(2, 2, device="cpu"))
    return _MESHES[kind]


def _axis(kind):
    return "data" if kind == "1d" else ("dcn", "ici")


def _np(t):
    return t.detach().cpu().numpy().copy()


def _grads_np(g):
    return {k: _np(v) for k, v in g.items()}


def _serial(m):
    """(log likelihood + log prior, its gradient by free raw name)."""
    raw = {k: v.clone().requires_grad_(True) for k, v in m.get_raw_dict(free_only=True).items()}
    with m.bind_raw_dict(raw):
        v = m.log_likelihood() + m.log_prior()
    g = torch.autograd.grad(v, list(raw.values()), allow_unused=True)
    return float(v), {k: np.zeros(tuple(r.shape)) if gi is None else _np(gi)
                      for (k, r), gi in zip(raw.items(), g)}


def _port_svgp(p):
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.likelihoods import Gaussian
    from gpy_tpu_torch.models import SVGP
    from gpy_tpu_torch.util.convert import load_raw_params

    m = SVGP(p["X"], p["Y"], p["Z"], RBF(1, device="cpu"), Gaussian(variance=0.2, device="cpu"),
             device="cpu")
    load_raw_params(m, p["raw"])
    return m


def _case_mesh(p):
    import torch.distributed as dist
    from gpy_tpu_torch.parallel import replicate, shard_rows

    out = {}
    for kind in ("1d", "2d"):
        mesh = _mesh(kind)
        rows = shard_rows(mesh, np.arange(8.0)[:, None], _axis(kind))
        tree = replicate(mesh, {"a": np.full(3, float(dist.get_rank())), "b": [np.ones(2)]})
        out[kind] = {"names": mesh.mesh_dim_names, "shape": tuple(mesh.shape),
                     "rows": _np(rows)[:, 0], "a": _np(tree["a"]), "b": _np(tree["b"][0])}
    out["world"] = dist.get_world_size()
    return out


def _case_svgp_elbo(p):
    from gpy_tpu_torch.parallel import data_parallel_elbo_and_grad, pad_rows_to_multiple

    m = _port_svgp(p)
    Xp, Yp, w = pad_rows_to_multiple(p["X"], p["Y"], WORLD)
    val, g = data_parallel_elbo_and_grad(m, _mesh(p["mesh"]), Xp, Yp, w,
                                         axis_name=_axis(p["mesh"]))
    sv, sg = _serial(m)
    return {"val": float(val), "grads": _grads_np(g), "serial": sv, "serial_grads": sg}


def _count_all_reduce(fn):
    """fn()'s result and the element count of each torch.distributed
    all_reduce it made."""
    import torch.distributed as dist

    calls, orig = [], dist.all_reduce

    def counting(t, *a, **kw):
        calls.append(t.numel())
        return orig(t, *a, **kw)

    dist.all_reduce = counting
    try:
        return fn(), calls
    finally:
        dist.all_reduce = orig


def _case_svgp_train(p):
    from gpy_tpu_torch.parallel import (pad_rows_to_multiple, sharded_svgp_train_step,
                                        svgp_unwhiten_raw, svgp_whiten_raw)

    m = _port_svgp(p)
    mesh = _mesh(p["mesh"])
    Xp, Yp, w = pad_rows_to_multiple(p["X"], p["Y"], WORLD)
    step, (raw, state), shard = sharded_svgp_train_step(
        m, mesh, step_size=5e-2, axis_name=_axis(p["mesh"]), whiten=p["whiten"])
    out = {"n_raw": sum(v.numel() for v in raw.values())}
    if p["whiten"]:
        raw0 = m.get_raw_dict(free_only=True)
        out["whitened"] = _np(svgp_whiten_raw(m, raw0)["q_u_chol"])
        out["returned"] = _np(raw["q_u_chol"])
        back = svgp_unwhiten_raw(m, raw)
        out["roundtrip"] = {k: (_np(back[k]), _np(raw0[k])) for k in ("q_u_mean", "q_u_chol")}
    Xs, Ys, ws = shard(Xp), shard(Yp), shard(w)
    vals, calls = [], []
    for i in range(p["steps"]):
        (raw, state, v), c = _count_all_reduce(lambda: step(raw, state, Xs, Ys, ws))
        vals.append(float(v))
        calls.append(c)
    out.update(vals=vals, calls=calls, serial=_serial(m)[0])
    final = svgp_unwhiten_raw(m, raw) if p["whiten"] else raw
    m.set_raw_dict(final)
    out["final"] = float(m.log_likelihood() + m.log_prior())
    return out


def _case_gram_matvec(p):
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.parallel import sharded_gram_matvec

    k = RBF(3, variance=0.9, lengthscale=1.1, device="cpu")
    X, V, noise = (torch.as_tensor(p[n]) for n in ("X", "V", "noise"))
    out = {}
    for fused in (False, True):
        out[fused] = _np(sharded_gram_matvec(_mesh("1d"), k, X, V, noise=noise, block=64,
                                             fused=fused))
    with torch.no_grad():
        out["dense"] = _np((k.K(X) + torch.diag(noise)) @ V)
    return out


def _case_iterative(p):
    from gpy_tpu_torch.inference import IterativeGaussianInference
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import GPRegression
    from gpy_tpu_torch.parallel import sharded_iterative_nlml_grad

    def probes(n, dtype, device):
        return torch.tensor(p["Z"], dtype=dtype, device=device)

    inf = IterativeGaussianInference(max_cg=60, n_probes=8, block=64, seed=0, materialize=False)
    inf._rademacher = probes
    m = GPRegression(p["X"], p["Y"], RBF(2, 1.1, 1.4, device="cpu"), noise_var=0.1,
                     inference_method=inf, device="cpu")
    flat = m.get_flat_raw()
    fn = sharded_iterative_nlml_grad(_mesh(p["mesh"]), m, max_cg=60, n_probes=8, block=64,
                                     seed=0, axis_name=_axis(p["mesh"]))
    fn.inference._rademacher = probes
    v, g = fn(flat)
    sv, sg = m._objective_and_grad(flat)
    return {"val": float(v), "grad": _np(g), "serial": sv, "serial_grad": sg}


def _case_vardtc(p):
    from gpy_tpu_torch.models import SparseGPRegression
    from gpy_tpu_torch.parallel import sharded_vardtc_elbo_and_grad
    from gpy_tpu_torch.util.convert import load_raw_params

    m = SparseGPRegression(p["X"], p["Y"], num_inducing=p["Z"].shape[0], Z=p["Z"], device="cpu")
    load_raw_params(m, p["raw"])
    (val, g), calls = _count_all_reduce(
        lambda: sharded_vardtc_elbo_and_grad(m, _mesh(p["mesh"]), axis_name=_axis(p["mesh"])))
    sv, sg = _serial(m)
    return {"val": float(val), "grads": _grads_np(g), "serial": sv, "serial_grads": sg,
            "calls": calls}


def _case_bgplvm(p):
    from gpy_tpu_torch.models import BayesianGPLVM
    from gpy_tpu_torch.parallel import sharded_bgplvm_elbo_and_grad
    from gpy_tpu_torch.util.convert import load_raw_params

    m = BayesianGPLVM(p["Y"], 3, num_inducing=7, device="cpu")
    load_raw_params(m, p["raw"])
    (val, g), calls = _count_all_reduce(lambda: sharded_bgplvm_elbo_and_grad(m, _mesh("1d")))
    sv, sg = _serial(m)
    return {"val": float(val), "grads": _grads_np(g), "serial": sv, "serial_grads": sg,
            "calls": calls}


def _case_multiout(p):
    from gpy_tpu_torch.models import GPMultioutRegression, GPMultioutRegressionMD
    from gpy_tpu_torch.parallel import (sharded_svi_multiout_elbo_and_grad,
                                        sharded_svi_multiout_md_elbo_and_grad)
    from gpy_tpu_torch.util.convert import load_raw_params

    if p["md"]:
        m = GPMultioutRegressionMD(p["X"], p["Y"], p["indexD"], Xr_dim=2, num_inducing=(6, 2),
                                   init="rand", heter_noise=True, device="cpu")
        fn = sharded_svi_multiout_md_elbo_and_grad
    else:
        m = GPMultioutRegression(p["X"], p["Y"], Xr_dim=2, num_inducing=(6, 2), init="rand",
                                 device="cpu")
        fn = sharded_svi_multiout_elbo_and_grad
    load_raw_params(m, p["raw"])
    (val, g), calls = _count_all_reduce(lambda: fn(m, _mesh("1d")))
    sv, sg = _serial(m)
    return {"val": float(val), "grads": _grads_np(g), "serial": sv, "serial_grads": sg,
            "calls": calls}


def _restart_model(p):
    from gpy_tpu_torch.models import GPRegression

    return GPRegression(p["X"], p["Y"], device="cpu")


def _case_restarts(p):
    m = _restart_model(p)
    res = m.optimize_restarts(num_restarts=8, parallel=True, max_iters=150, step_size=5e-2,
                              seed=0, verbose=False, mesh=_mesh("1d"))
    return {"f": [r.f_opt for r in res], "kept": _np(m.get_flat_raw())}


def _case_hmc(p):
    from gpy_tpu_torch import mcmc
    from gpy_tpu_torch.models import GPRegression

    m = GPRegression(p["X"], p["Y"], device="cpu")
    hmc = mcmc.HMC(m, stepsize=0.05, num_leapfrog=5)
    kw = dict(num_samples=10, num_chains=8, seed=1)
    sharded = hmc.sample(mesh=_mesh(p["mesh"]), **kw)
    rate = hmc._accept_rate
    whole = hmc.sample(**kw)
    return {"sharded": sharded, "whole": whole, "rate": rate, "whole_rate": hmc._accept_rate}


_CASES = {n[len("_case_"):]: f for n, f in list(globals().items()) if n.startswith("_case_")}


# --- reference side (the pytest process) ----------------------------------------

@pytest.fixture(scope="module")
def jx():
    import jax

    assert len(jax.devices()) == 8
    return jax


def _ref_mesh(kind):
    from gpy_tpu.parallel import make_mesh, make_mesh_2d

    return make_mesh(4) if kind == "1d" else make_mesh_2d(n_dcn=2, n_ici=2)


def _raw_np(m):
    return {k: np.asarray(v, dtype=np.float64) for k, v in m.get_raw_dict().items()}


def _close_grads(got, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=rtol, atol=atol, err_msg=k)


def _same_on_every_rank(res, key="val"):
    for r in res[1:]:
        assert r[key] == res[0][key]


def _svgp_inputs(n, seed):
    from gpy_tpu.core.svgp import SVGP
    from gpy_tpu.likelihoods import Gaussian
    import gpy_tpu.kern as gk

    rng = np.random.default_rng(seed)
    X = np.linspace(0, 5, n).reshape(n, 1)
    Y = np.sin(X) + 0.2 * rng.standard_normal((n, 1))
    jm = SVGP(X, Y, X[::6].copy(), gk.RBF(1), Gaussian(variance=0.2))
    # q(u) away from the prior, so that every gradient is exercised
    jm.set_raw_dict({"q_u_mean": 0.3 * rng.standard_normal((jm.Z.shape[0], 1))})
    return jm, {"X": X, "Y": Y, "Z": np.asarray(jm.Z), "raw": _raw_np(jm)}


@pytest.mark.parametrize("n,mesh", [(48, "1d"), (45, "1d"), (48, "2d")],
                         ids=["serial", "padding", "mesh_2d"])
def test_sharded_elbo_matches_reference_and_serial(ranks, jx, n, mesh):
    """data_parallel_elbo_and_grad: the reference's sharded ELBO and
    gradients, and the port's serial model's (n = 45 pads to 48)."""
    from gpy_tpu.parallel import data_parallel_elbo_and_grad, pad_rows_to_multiple

    jm, payload = _svgp_inputs(n, seed=5)
    ranks.submit("svgp_elbo", dict(payload, mesh=mesh))
    ax = "data" if mesh == "1d" else ("dcn", "ici")
    Xp, Yp, w = pad_rows_to_multiple(payload["X"], payload["Y"], WORLD)
    rv, rg = jx.jit(lambda: data_parallel_elbo_and_grad(jm, _ref_mesh(mesh), Xp, Yp, w,
                                                        axis_name=ax))()
    res = ranks.result()
    out = res[0]
    _same_on_every_rank(res)
    assert out["val"] == pytest.approx(float(rv), rel=VAL_REL)
    _close_grads(out["grads"], rg)
    assert out["val"] == pytest.approx(out["serial"], rel=SERIAL_REL)
    _close_grads(out["grads"], out["serial_grads"], rtol=SERIAL_REL, atol=1e-12)


def test_ranks_and_meshes(ranks):
    """The group's 4 ranks; make_mesh() is 1-D over them, make_mesh_2d(2, 2)
    is ("dcn", "ici"); shard_rows hands each rank its contiguous block (dcn
    major on the 2-D mesh) and replicate broadcasts the first rank's tree."""
    res = ranks.run("mesh", None)
    for r, out in enumerate(res):
        assert out["world"] == WORLD
        assert out["1d"]["names"] == ("data",) and out["1d"]["shape"] == (4,)
        assert out["2d"]["names"] == ("dcn", "ici") and out["2d"]["shape"] == (2, 2)
        for kind in ("1d", "2d"):
            np.testing.assert_array_equal(out[kind]["rows"], [2.0 * r, 2.0 * r + 1])
            np.testing.assert_array_equal(out[kind]["a"], np.zeros(3))
            np.testing.assert_array_equal(out[kind]["b"], np.ones(2))


@pytest.mark.parametrize("mesh,whiten,steps", [("1d", False, 20), ("1d", True, 20),
                                               ("2d", False, 10)],
                         ids=["plain", "whitened", "mesh_2d"])
def test_sharded_train_step_improves(ranks, mesh, whiten, steps):
    """sharded_svgp_train_step: the ELBO at the first step is the serial
    one and rises over the steps; each step is one all_reduce of |raw| + 1
    numbers a mesh axis (one on the 1-D mesh, two on the 2 x 2); whitening
    round-trips and the trained, unwhitened model is at least as good as
    the start."""
    _, payload = _svgp_inputs(48, seed=5)
    res = ranks.run("svgp_train", dict(payload, mesh=mesh, whiten=whiten, steps=steps))
    out = res[0]
    _same_on_every_rank(res, "vals")
    assert out["vals"][0] == pytest.approx(out["serial"], rel=SERIAL_REL)
    assert out["vals"][-1] > out["vals"][0]
    assert out["final"] >= out["vals"][0] and np.isfinite(out["final"])
    axes = 1 if mesh == "1d" else 2
    assert out["calls"] == [[out["n_raw"] + 1] * axes] * steps
    if whiten:
        np.testing.assert_allclose(out["returned"], out["whitened"], rtol=1e-9, atol=1e-10)
        for got, ref in out["roundtrip"].values():
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-10)


def test_sharded_gram_matvec_equals_dense(ranks, jx):
    """Row-sharded K @ V, blockwise and through B5's slab (its plain twin
    here, float32), against the dense product and the reference's sharded
    product."""
    from gpy_tpu.parallel import sharded_gram_matvec
    import gpy_tpu.kern as gk

    rng = np.random.default_rng(0)
    N = 64 * WORLD
    p = {"X": rng.uniform(0, 5, (N, 3)), "V": rng.standard_normal((N, 4)),
         "noise": np.full(N, 0.2)}
    ranks.submit("gram_matvec", p)
    ref = jx.jit(lambda: sharded_gram_matvec(_ref_mesh("1d"), gk.RBF(3, variance=0.9,
                                                                     lengthscale=1.1),
                                             p["X"], p["V"], noise=p["noise"], block=64))()
    out = ranks.result()[0]
    np.testing.assert_allclose(out[False], out["dense"], atol=1e-12)
    np.testing.assert_allclose(out[False], np.asarray(ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out[True], out["dense"], atol=2e-5)


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_sharded_iterative_nlml_matches_reference(ranks, jx, mesh):
    """The sharded iterative NLML and gradient with the reference's
    Rademacher probes handed in: against the reference's sharded function
    and the port's serial blockwise model at the same probes."""
    import jax.numpy as jnp
    from gpy_tpu.inference.iterative import IterativeGaussianInference
    from gpy_tpu.models import GPRegression
    from gpy_tpu.parallel import sharded_iterative_nlml_grad
    import gpy_tpu.kern as gk

    rng = np.random.default_rng(1)
    N = 40 * WORLD
    X = rng.uniform(0, 8, (N, 2))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    Z = np.asarray(jx.random.rademacher(jx.random.PRNGKey(0), (N, 8), dtype=jnp.float64))
    ranks.submit("iterative", {"X": X, "Y": Y, "Z": Z, "mesh": mesh})
    jm = GPRegression(X, Y, kernel=gk.RBF(2, 1.1, 1.4), noise_var=0.1,
                      inference_method=IterativeGaussianInference(max_cg=60, n_probes=8,
                                                                  block=64, seed=0))
    ax = "data" if mesh == "1d" else ("dcn", "ici")
    fn = sharded_iterative_nlml_grad(_ref_mesh(mesh), jm, max_cg=60, n_probes=8, block=64, seed=0,
                                     axis_name=ax)
    rv, rg = fn(jm.get_flat_raw())
    res = ranks.result()
    out = res[0]
    _same_on_every_rank(res)
    assert out["val"] == pytest.approx(float(rv), rel=VAL_REL)
    np.testing.assert_allclose(out["grad"], np.asarray(rg), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert out["val"] == pytest.approx(out["serial"], rel=SERIAL_REL)
    np.testing.assert_allclose(out["grad"], out["serial_grad"], rtol=SERIAL_REL, atol=1e-12)


def _vardtc_inputs(kind):
    from gpy_tpu.models import SparseGPRegression

    rng = np.random.default_rng(7)
    if kind == "1d":
        N, M = 83, 9   # 83 rows pad to 84
        X = rng.random((N, 3)) * 5.0
        Y = np.concatenate([np.sin(X[:, :1]), np.cos(X[:, :1])], 1) \
            + 0.1 * rng.standard_normal((N, 2))
    else:
        N, M = 41, 6
        X = np.linspace(0, 5, N).reshape(-1, 1)
        Y = np.sin(X) + 0.2 * rng.standard_normal((N, 1))
    Z = X[:M].copy()
    jm = SparseGPRegression(X, Y, num_inducing=M, Z=Z)
    return jm, {"X": X, "Y": Y, "Z": Z, "raw": _raw_np(jm), "mesh": kind}


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_sharded_vardtc_matches_reference_and_serial(ranks, jx, mesh):
    """Row-sharded VarDTC (padded rows): the reference's sharded bound and
    gradients, the port's serial SparseGPRegression, and two packed
    all_reduces an evaluation a mesh axis."""
    from gpy_tpu.parallel import sharded_vardtc_elbo_and_grad

    jm, payload = _vardtc_inputs(mesh)
    ranks.submit("vardtc", payload)
    ax = "data" if mesh == "1d" else ("dcn", "ici")
    rv, rg = sharded_vardtc_elbo_and_grad(jm, _ref_mesh(mesh), axis_name=ax)
    res = ranks.result()
    out = res[0]
    _same_on_every_rank(res)
    assert out["val"] == pytest.approx(float(rv), rel=VAL_REL)
    _close_grads(out["grads"], rg)
    assert out["val"] == pytest.approx(out["serial"], rel=SERIAL_REL)
    _close_grads(out["grads"], out["serial_grads"], rtol=SERIAL_REL, atol=1e-12)
    assert len(out["calls"]) == 2 * (1 if mesh == "1d" else 2)


def test_sharded_bgplvm_matches_reference_and_serial(ranks, jx):
    """q(X)-row-sharded BGPLVM (43 rows pad to 44): value and every
    gradient, the q(X) ones reassembled from the ranks, against the
    reference's sharded bound and the port's serial model; two all_reduces."""
    from gpy_tpu.models import BayesianGPLVM
    from gpy_tpu.parallel import sharded_bgplvm_elbo_and_grad

    rng = np.random.default_rng(8)
    N, Dy = 43, 4
    Y = rng.standard_normal((N, 2)) @ rng.standard_normal((2, Dy)) \
        + 0.1 * rng.standard_normal((N, Dy))
    jm = BayesianGPLVM(Y, 3, num_inducing=7)
    ranks.submit("bgplvm", {"Y": Y, "raw": _raw_np(jm)})
    rv, rg = sharded_bgplvm_elbo_and_grad(jm, _ref_mesh("1d"))
    res = ranks.result()
    out = res[0]
    _same_on_every_rank(res)
    assert out["val"] == pytest.approx(float(rv), rel=VAL_REL)
    _close_grads(out["grads"], rg)
    assert out["val"] == pytest.approx(out["serial"], rel=SERIAL_REL)
    _close_grads(out["grads"], out["serial_grads"], rtol=SERIAL_REL, atol=1e-12)
    assert len(out["calls"]) == 2


def _multiout_inputs(md):
    from gpy_tpu.models import GPMultioutRegression, GPMultioutRegressionMD

    if not md:
        rng2 = np.random.default_rng(11)
        n, d = 21, 5   # 21 rows over 4 ranks: padding
        X = np.linspace(0, 5, n).reshape(-1, 1)
        Y = np.hstack([np.sin(X) * wgt for wgt in np.linspace(0.5, 1.5, d)])
        Y += 0.05 * rng2.standard_normal((n, d))
        jm = GPMultioutRegression(X, Y, Xr_dim=2, num_inducing=(6, 2), init="rand")
        return jm, {"X": X, "Y": Y, "raw": _raw_np(jm), "md": False}
    rng2 = np.random.default_rng(12)
    Xl, Yl, il = [], [], []
    for di in range(4):
        Xd = np.linspace(0, 5, 9).reshape(-1, 1) + 0.1 * di
        Xl.append(Xd)
        Yl.append(np.sin(Xd) * (0.5 + 0.3 * di) + 0.05 * rng2.standard_normal((9, 1)))
        il.append(np.full(9, di))
    X, Y, indexD = np.vstack(Xl), np.vstack(Yl), np.concatenate(il)
    jm = GPMultioutRegressionMD(X, Y, indexD, Xr_dim=2, num_inducing=(6, 2), init="rand",
                                heter_noise=True)
    return jm, {"X": X, "Y": Y, "indexD": indexD, "raw": _raw_np(jm), "md": True}


@pytest.mark.parametrize("md", [False, True], ids=["full", "missing_data"])
def test_sharded_svi_multiout_matches_reference_and_serial(ranks, jx, md):
    """LVMOGP's bounds (the full one over 21 rows, the missing-data one with
    a noise per output over 36 stacked rows) sharded over the rows, against
    the reference's sharded bounds and the port's serial models."""
    from gpy_tpu.parallel import (sharded_svi_multiout_elbo_and_grad,
                                  sharded_svi_multiout_md_elbo_and_grad)

    jm, payload = _multiout_inputs(md)
    ranks.submit("multiout", payload)
    fn = sharded_svi_multiout_md_elbo_and_grad if md else sharded_svi_multiout_elbo_and_grad
    rv, rg = fn(jm, _ref_mesh("1d"))
    res = ranks.result()
    out = res[0]
    _same_on_every_rank(res)
    assert out["val"] == pytest.approx(float(rv), rel=VAL_REL)
    _close_grads(out["grads"], rg)
    assert out["val"] == pytest.approx(out["serial"], rel=SERIAL_REL)
    _close_grads(out["grads"], out["serial_grads"], rtol=SERIAL_REL, atol=1e-12)
    assert len(out["calls"]) == 2


def test_mesh_sharded_parallel_restarts(ranks, jx):
    """8 parallel restarts, 2 a rank: the best objective of the reference's
    mesh-sharded restarts (tests/test_parallel.py), and every rank keeps
    the same best point."""
    from gpy_tpu.models import GPRegression

    rng = np.random.default_rng(3)
    X = np.linspace(0, 5, 30).reshape(-1, 1)
    Y = np.sin(X) + 0.2 * rng.standard_normal((30, 1))
    ranks.submit("restarts", {"X": X, "Y": Y})
    r = GPRegression(X, Y).optimize_restarts(num_restarts=8, parallel=True, max_iters=150,
                                             step_size=5e-2, seed=0, verbose=False,
                                             mesh=_ref_mesh("1d"))
    res = ranks.result()
    assert min(res[0]["f"]) == pytest.approx(min(x.f_opt for x in r), rel=1e-5)
    for out in res[1:]:
        np.testing.assert_array_equal(out["kept"], res[0]["kept"])
        assert out["f"] == res[0]["f"]


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_hmc_mesh_equals_unsharded(ranks, mesh):
    """HMC.sample(mesh=...): 8 chains, 2 a rank, return on every rank the
    unsharded call's (8, S, P) samples and acceptance."""
    rng = np.random.default_rng(4)
    X = rng.random((40, 1)) * 4.0
    Y = np.sin(X) + 0.1 * rng.standard_normal((40, 1))
    for out in ranks.run("hmc", {"X": X, "Y": Y, "mesh": mesh}):
        assert out["sharded"].shape == (8, 10, 3)
        np.testing.assert_allclose(out["sharded"], out["whole"], rtol=1e-12, atol=0)
        assert out["rate"] == pytest.approx(out["whole_rate"], rel=1e-12)


# --- in the pytest process -----------------------------------------------------

_LAUNCHER = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["no_launcher", "nowhere", "incomplete"])
def test_distributed_initialize(monkeypatch, case):
    """No launcher environment: False, as the reference. A coordinator that
    does not answer, or an incomplete environment, raises where the
    reference returns False (ROADMAP C(ai))."""
    import torch.distributed as dist
    from gpy_tpu_torch.parallel import distributed_initialize

    for k in _LAUNCHER:
        monkeypatch.delenv(k, raising=False)
    if case == "no_launcher":
        assert distributed_initialize() is False
    elif case == "nowhere":
        # rank 1 of 2 waits for a coordinator on a closed local port
        for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(_free_port())),
                     ("WORLD_SIZE", "2"), ("RANK", "1")):
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError) as e:
            distributed_initialize(device="cpu", timeout=datetime.timedelta(seconds=0.2))
        assert "CUDA" not in str(e.value)
    else:
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="MASTER_ADDR"):
            distributed_initialize(device="cpu")
    assert not dist.is_initialized()


def test_cuda_request_without_a_card_raises(monkeypatch):
    """make_mesh() and distributed_initialize() run on "cuda" unless asked:
    without a card they raise instead of falling back to the CPU."""
    import torch.distributed as dist
    from gpy_tpu_torch.parallel import distributed_initialize, make_mesh, make_mesh_2d

    assert not torch.cuda.is_available()
    for fn in (make_mesh, make_mesh_2d):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed_initialize()
    assert not dist.is_initialized()
