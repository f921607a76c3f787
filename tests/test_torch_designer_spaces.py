"""The GP designers on the benchmark slice's spaces: the JAX package's and the
port's DEFAULT (``VizierGPUCBPEBandit``) and GAUSSIAN_PROCESS_BANDIT
(``VizierGPBandit``) on the same studies, on the CPU.

Two studies, at small depth:
- NASBench-101 over ``synthetic_nasbench101``'s table: 21 bools and 5 op
  categoricals, so no continuous feature (``Dc=0``, ``Ds=26``); invalid or
  untabulated graphs complete infeasible;
- ``SparseExperimenter.create_default`` with 20 placeholder floats around
  the 20-D Sphere: 40 floats (``Dc=40``).

The packages draw different random numbers (ROADMAP C4), so they are held
where the comparison is deterministic: equal encoded data (features,
warped labels of feasible and infeasible rows, masks) within 1e-6, and, at
the JAX designer's trained ARD parameters, the port's NLL within 1e-5
relative and its posterior mean and stddev at 25 queries within 1e-4.
Suggestions lie in their spaces on both sides. ``PredictorExperimenter``
over each designer, at those parameters and with the JAX package's
standard normals fed to the port's samples, gives the JAX package's
objective values within 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (one torch CPU thread per test process)

from vizier_tpu import pyvizier as jvz
from vizier_tpu.algorithms import core as jcore
from vizier_tpu.benchmarks.experimenters import base as jbase
from vizier_tpu.benchmarks.experimenters import nasbench101 as jnb
from vizier_tpu.benchmarks.experimenters import surrogates as jsur
from vizier_tpu.benchmarks.experimenters import wrappers as jwrap
from vizier_tpu.benchmarks.experimenters.synthetic import bbob as jbbob
from vizier_tpu.designers import gp_bandit as jgb
from vizier_tpu.designers import gp_ucb_pe as jucb
from vizier_tpu.designers import random as jrandom
from vizier_tpu.models import kernels as jk
from vizier_tpu_torch import interop
from vizier_tpu_torch import pyvizier as tvz
from vizier_tpu_torch.algorithms import core as tcore
from vizier_tpu_torch.benchmarks.experimenters import base as tbase
from vizier_tpu_torch.benchmarks.experimenters import nasbench101 as tnb
from vizier_tpu_torch.benchmarks.experimenters import surrogates as tsur
from vizier_tpu_torch.benchmarks.experimenters import wrappers as twrap
from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob as tbbob
from vizier_tpu_torch.designers import gp_bandit as tgb
from vizier_tpu_torch.designers import gp_ucb_pe as tucb
from vizier_tpu_torch.designers import random as trandom
from vizier_tpu_torch.models import gp as tgp
from vizier_tpu_torch.models import kernels as tk

_SIDES = {
    "jax": dict(vz=jvz, core=jcore, base=jbase, nb=jnb, sur=jsur, wrap=jwrap, bbob=jbbob,
                random=jrandom, designers={"DEFAULT": jucb.VizierGPUCBPEBandit,
                                           "GAUSSIAN_PROCESS_BANDIT": jgb.VizierGPBandit}),
    "port": dict(vz=tvz, core=tcore, base=tbase, nb=tnb, sur=tsur, wrap=twrap, bbob=tbbob,
                 random=trandom, designers={"DEFAULT": tucb.VizierGPUCBPEBandit,
                                            "GAUSSIAN_PROCESS_BANDIT": tgb.VizierGPBandit}),
}
_NUM_TRIALS = 24
_KW = dict(ard_restarts=2, max_acquisition_evaluations=400, num_seed_trials=5)


def _nasbench(m):
    api, specs = m["nb"].synthetic_nasbench101(num_cells=32, seed=0)
    return m["nb"].NASBench101Experimenter(api), specs


def _sparse_sphere(m):
    inner = m["base"].NumpyExperimenter(m["bbob"].Sphere, m["base"].bbob_problem(20))
    return m["wrap"].SparseExperimenter.create_default(inner, num_float=20), None


_SPACES = {"nasbench101": (_nasbench, 0, 26), "sparse_sphere": (_sparse_sphere, 40, 0)}


def _study(m, space: str):
    """The experimenter and its completed trials: random points, every
    other one a tabulated NASBench cell so that some are feasible."""
    experimenter, specs = _SPACES[space][0](m)
    problem = experimenter.problem_statement()
    rng = np.random.default_rng(3)
    trials = []
    for i in range(_NUM_TRIALS):
        params = m["random"].sample_point(problem.search_space, rng)
        if specs is not None and i % 2 == 0:
            spec = specs[i % len(specs)]
            for y in range(7):
                for x in range(y):
                    params[f"{x}_{y}"] = str(bool(spec.matrix[x][y]))
            for k in range(5):
                params[f"ops_{k}"] = spec.ops[k + 1]
        trials.append(m["vz"].Trial(id=i + 1, parameters=params))
    experimenter.evaluate(trials)
    return experimenter, trials


@pytest.fixture(scope="module", params=[(s, a) for s in _SPACES
                                        for a in ("DEFAULT", "GAUSSIAN_PROCESS_BANDIT")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def trained(request):
    """(space, algorithm, {side: (experimenter, designer, suggestions,
    trials)}) after one update and one suggest(2)."""
    space, algorithm = request.param
    out = {}
    for side, m in _SIDES.items():
        experimenter, trials = _study(m, space)
        kw = dict(_KW, use_mesh=False) if side == "jax" else dict(_KW, device="cpu")
        designer = m["designers"][algorithm](experimenter.problem_statement(), **kw)
        designer.update(m["core"].CompletedTrials(trials), m["core"].ActiveTrials())
        out[side] = (experimenter, designer, designer.suggest(2), trials)
    return space, algorithm, out


def _port_data(designer):
    if isinstance(designer, tucb.VizierGPUCBPEBandit):
        _, (data,) = designer._train_states_me()
        return data
    return tgp.GPData.from_model_data(designer._warped_model_data(), designer.device)


def _port_state_at_jax_params(jd, td):
    """(the JAX designer's trained parameters [E, ...] and its data, the
    port's data, the port's posterior at those parameters)."""
    jstates = jd._last_predictive.states
    params = {k: np.asarray(v) for k, v in jstates.params.items()}
    jdata = jax.tree_util.tree_map(lambda x: x[0], jstates.data)  # one dataset per member
    tdata = _port_data(td)
    return params, jdata, tdata, td._model.precompute_constrained(
        interop.gp_params_from_numpy(params, "cpu"), tdata)


def test_the_spaces_have_the_slices_layouts(trained):
    space, _, out = trained
    _, td, _, trials = out["port"]
    data = _port_data(td)
    assert int(data.cont_dim_mask.sum()) == _SPACES[space][1]
    assert int(data.cat_dim_mask.sum()) == _SPACES[space][2]
    feasible = sum(t.final_measurement is not None for t in trials)
    assert 0 < feasible <= _NUM_TRIALS
    if space == "nasbench101":
        assert feasible < _NUM_TRIALS  # infeasible rows reach the designers too


def test_both_designers_suggest_inside_the_space(trained):
    _, _, out = trained
    for side, (experimenter, _, suggestions, _) in out.items():
        space = experimenter.problem_statement().search_space
        assert len(suggestions) == 2
        for s in suggestions:
            assert set(s.parameters) == set(space.parameter_names()), side
            for name in space.parameter_names():
                assert space.get(name).contains(s.parameters[name].value), (side, name)


def test_encoded_data_is_equal(trained):
    _, _, out = trained
    _, jdata, tdata, _ = _port_state_at_jax_params(out["jax"][1], out["port"][1])
    for field in ("continuous", "categorical", "labels", "row_mask"):
        np.testing.assert_allclose(getattr(tdata, field).numpy(),
                                   np.asarray(getattr(jdata, field)), atol=1e-6)


def test_nll_at_the_jax_trained_parameters_is_equal(trained):
    _, _, out = trained
    jd, td = out["jax"][1], out["port"][1]
    params, jdata, tdata, _ = _port_state_at_jax_params(jd, td)
    unconstrained = jd._model.param_collection().unconstrain(
        {k: jnp.asarray(v) for k, v in params.items()})
    want = np.asarray(jax.vmap(jd._model.neg_log_likelihood, in_axes=(0, None))(
        unconstrained, jdata))
    got = td._model.neg_log_likelihood(
        interop.gp_params_from_numpy({k: np.asarray(v) for k, v in unconstrained.items()},
                                     "cpu"), tdata).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_posterior_at_the_jax_trained_parameters_is_equal(trained):
    space, _, out = trained
    jd, td = out["jax"][1], out["port"][1]
    _, _, tdata, tstate = _port_state_at_jax_params(jd, td)
    rng = np.random.default_rng(1)
    dc, ds = tdata.continuous.shape[-1], tdata.categorical.shape[-1]
    q = rng.uniform(size=(25, dc)).astype(np.float32)
    zq = rng.integers(0, 2, size=(25, ds)).astype(np.int32)
    jmean, jstd = jd._last_predictive.predict(jk.MixedFeatures(jnp.asarray(q), jnp.asarray(zq)))
    tmean, tstd = tgp.EnsemblePredictive(tstate).predict(
        tk.MixedFeatures(torch.tensor(q), torch.tensor(zq)))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-4)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(jstd), atol=1e-4)


class _FedDraws:
    """The port's designer as a Predictor that samples the JAX package's
    standard normals: the key comes from the experimenter's rng as the JAX
    designers derive it (``gp_bandit._as_prng_key``), the draws have the
    JAX designer's shape (``[S, T]``, or ``[S, M, T]`` for the DEFAULT)."""

    def __init__(self, designer):
        self._designer = designer

    def predict(self, suggestions, rng):
        key = jax.random.PRNGKey(int(rng.integers(0, 2**31 - 1)))
        shape = (1000, len(suggestions))
        if isinstance(self._designer, tucb.VizierGPUCBPEBandit):
            shape = (1000, 1, len(suggestions))
        eps = torch.tensor(np.asarray(jax.random.normal(key, shape)))
        samples = self._designer._samples_from_draws(suggestions, eps)
        return tcore.Prediction(mean=np.mean(samples, axis=0), stddev=np.std(samples, axis=0))


def test_predictor_experimenter_on_fed_draws(trained):
    """Each designer's posterior as the objective of a random run."""
    _, _, out = trained
    jd, td = out["jax"][1], out["port"][1]
    _, _, tdata, tstate = _port_state_at_jax_params(jd, td)
    if isinstance(td, tucb.VizierGPUCBPEBandit):
        td._cached_states = ([tstate], [tdata])
    else:
        td._last_predictive = tgp.EnsemblePredictive(tstate)
    values = {}
    for side, predictor in (("jax", jd), ("port", _FedDraws(td))):
        m = _SIDES[side]
        problem = out[side][0].problem_statement()
        experimenter = m["sur"].PredictorExperimenter(predictor, problem, seed=4)
        designer = m["random"].RandomDesigner(problem.search_space, seed=2)
        trials = [s.to_trial(i + 1) for i, s in enumerate(designer.suggest(6))]
        experimenter.evaluate(trials)
        name = problem.metric_information.item().name
        values[side] = [t.final_measurement.metrics[name].value for t in trials]
    np.testing.assert_allclose(values["port"], values["jax"], rtol=1e-4, atol=1e-4)


def test_the_cards_benchmarks_phase_runs_its_host_path_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s benchmarks phase with ``device="cpu"``: every
    study at its layout, each trial completed inside its space, the
    PredictorExperimenter equal to ``predict``, the analyzers over the
    states. (The card's checks, K1/K2 and the posterior against the CPU,
    run on the card only.)"""
    import chip_smoke
    from vizier_tpu_torch.models import kernels

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args, **kw: None)
    paths, figures = chip_smoke.run_benchmarks_phase(kernels, None, device="cpu")
    layouts = {name: (f["dc"], f["ds"]) for name, f in figures.items()
               if isinstance(f, dict) and "dc" in f}
    assert layouts == {"nasbench101": (0, 26), "pest_control": (0, 25), "maxsat60": (0, 60),
                       "sparse_sphere20": (40, 0), "permuting_rastrigin4": (4, 0),
                       "normalizing_rosenbrock4": (4, 0), "sign_flip_sphere4": (4, 0)}
    assert set(paths) == set(layouts) | {"predictor_random"}
    assert figures["predictor_random"]["trials"] == 15
    assert set(figures["analysis"]) == {"nasbench101", "pest_control", "maxsat60"}
    assert kernels.LAUNCH_SHAPES is None
