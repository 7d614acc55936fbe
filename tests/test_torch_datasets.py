"""The port's dataset loaders, mocap and netpbm parsers: gpy_tpu_torch.util
.datasets, .mocap and .netpbmfile.

tests/test_datasets.py and tests/test_mocap_netpbm.py run here against the
port's modules: their source is read, its imports of gpy_tpu.util are
pointed at gpy_tpu_torch.util, and their cases (a fabricated local cache
in the upstream formats, forward-kinematics invariants, netpbm round
trips) are collected from this module. One case differs on purpose: the
port downloads nothing, so its loader surface has no download_url,
authorize_download or prompt_user, and a dataset missing from the cache
raises DatasetNotAvailable naming its source files whatever
GPY_TPU_DATA_AUTO says. The synthetic generators must give the
reference's arrays bit for bit from the same seeds.
"""
import os
import sys
import types

import numpy as np
import pytest

import gpy_tpu.util.datasets as jdatasets
from gpy_tpu_torch.util import datasets

_HERE = os.path.dirname(os.path.abspath(__file__))


def _port_copy(filename, modname):
    """The reference test module `filename`, its gpy_tpu.util imports
    pointed at gpy_tpu_torch.util."""
    with open(os.path.join(_HERE, filename)) as f:
        src = f.read().replace("gpy_tpu.util", "gpy_tpu_torch.util").replace(
            "from test_mocap_netpbm import", "from _port_test_mocap_netpbm import")
    assert "gpy_tpu_torch.util" in src
    mod = types.ModuleType(modname)
    mod.__file__ = os.path.join(_HERE, filename)
    sys.modules[modname] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


_mocap_cases = _port_copy("test_mocap_netpbm.py", "_port_test_mocap_netpbm")
_dataset_cases = _port_copy("test_datasets.py", "_port_test_datasets")
for _mod in (_mocap_cases, _dataset_cases):
    for _name, _obj in vars(_mod).items():
        if _name.startswith("test_") or _name in ("skel", "cache"):
            globals()[_name] = _obj
del test_loader_surface_complete  # noqa: F821  (the port's version follows)


def test_loader_surface_complete():
    """tests/test_datasets.py's loader list, less the download helpers the
    port leaves out."""
    names = [
        "boston_housing", "brendan_faces", "della_gatta_TRP63_gene_expression",
        "football_data", "sod1_mouse", "spellman_yeast", "spellman_yeast_cdc15",
        "lee_yeast_ChIP", "fruitfly_tomancak", "drosophila_protein",
        "drosophila_knirps", "google_trends", "oil", "oil_100", "pumadyn",
        "robot_wireless", "silhouette", "decampos_digits", "ripley_synth",
        "global_average_temperature", "mauna_loa", "boxjenkins_airline",
        "osu_run1", "swiss_roll_generated", "hapmap3", "singlecell",
        "singlecell_rna_seq_islam", "singlecell_rna_seq_deng",
        "swiss_roll_1000", "swiss_roll", "isomap_faces", "simulation_BGPLVM",
        "toy_rbf_1d", "toy_rbf_1d_50", "toy_linear_1d_classification",
        "olivetti_glasses", "olivetti_faces", "xw_pen",
        "download_rogers_girolami_data", "olympic_100m_men",
        "olympic_100m_women", "olympic_200m_women", "olympic_200m_men",
        "olympic_400m_women", "olympic_400m_men", "olympic_marathon_men",
        "olympic_sprints", "crescent_data", "creep_data", "cifar10_patches",
        "cmu_mocap_49_balance", "cmu_mocap_35_walk_jog", "cmu_mocap",
        "cmu_urls_files", "sample_class", "data_available", "download_data",
        "data_details_return",
    ]
    assert [n for n in names if not callable(getattr(datasets, n, None))] == []
    for gone in ("download_url", "authorize_download", "prompt_user"):
        assert not hasattr(datasets, gone)
    assert "urllib" not in open(datasets.__file__).read()


@pytest.mark.parametrize("name", ["boston_housing", "oil", "xw_pen", "della_gatta"])
def test_missing_dataset_names_its_source(tmp_path, monkeypatch, name):
    monkeypatch.setenv("GPY_DATA_PATH", str(tmp_path))
    monkeypatch.setenv("GPY_TPU_DATA_AUTO", "1")
    res = datasets.data_resources["three_phase_oil_flow" if name == "oil" else name]
    with pytest.raises(datasets.DatasetNotAvailable) as e:
        (datasets.della_gatta_TRP63_gene_expression if name == "della_gatta"
         else getattr(datasets, name))()
    assert res["urls"][0] in str(e.value) and res["files"][0][0] in str(e.value)
    assert os.listdir(tmp_path) == []  # nothing written
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.download_data("no_such_set")


@pytest.mark.parametrize("call", [
    "toy_rbf_1d()", "toy_rbf_1d(seed=3, num_samples=40, noise=0.1)", "toy_rbf_1d_50()",
    "toy_linear_1d_classification()", "toy_linear_1d_classification(seed=1, n=31)",
    "crescent_data()", "crescent_data(num_data=51, seed=2)", "oil_synthetic()",
    "oil_synthetic(seed=4, n=57)", "simulation_BGPLVM()", "simulation_BGPLVM(seed=1, n=13, q_true=2, d=7)",
    "swiss_roll_generated(300, sigma=0.1)", "olympic_marathon_men()",
])
def test_synthetic_generators_equal_the_reference(call, tmp_path, monkeypatch):
    monkeypatch.setenv("GPY_DATA_PATH", str(tmp_path))
    got, want = eval("datasets." + call), eval("jdatasets." + call)
    arrays = [k for k, v in want.items() if isinstance(v, np.ndarray)]
    assert arrays and set(arrays) == {k for k, v in got.items() if isinstance(v, np.ndarray)}
    for k in arrays:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_sample_class_draws_as_the_reference():
    f = np.linspace(-3, 3, 200).reshape(-1, 1)
    np.random.seed(7)
    got = datasets.sample_class(f)
    np.random.seed(7)
    np.testing.assert_array_equal(got, jdatasets.sample_class(f))
