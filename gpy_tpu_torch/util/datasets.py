"""Dataset loaders: the GPy/util/datasets.py surface on local files.

Counterpart of gpy_tpu/util/datasets.py (GPy/util/datasets.py and
GPy/util/data_resources.json). A resource registry (name -> source urls,
files, details) names each dataset; each loader parses the files from the
local cache directory (GPY_DATA_PATH or ~/.config/GPy/datasets, GPy's own
default, so an existing GPy cache is reused). The port downloads nothing:
a dataset missing from the cache raises `DatasetNotAvailable` naming its
source. The synthetic generators (`toy_*`, `crescent_data`,
`swiss_roll_generated`, `simulation_BGPLVM`, `oil_synthetic`) draw from
numpy's generators exactly as the reference does, so one seed gives both
packages the same arrays.
"""
from __future__ import annotations

import os
import tarfile
import zipfile

import numpy as np

default_seed = 10000

__all__ = [
    "DatasetNotAvailable", "data_path", "data_available", "download_data",
    "data_details_return", "data_resources",
]


class DatasetNotAvailable(RuntimeError):
    pass


def data_path():
    return os.environ.get("GPY_DATA_PATH", os.path.expanduser("~/.config/GPy/datasets"))


# --- resource registry (name -> source urls, files per url, short details) --
# Factual source metadata mirroring GPy/util/data_resources.json.
data_resources = {
    "ankur_pose_data": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/ankur_pose_data/"], "files": [["ankurDataPoseSilhouette.mat"]], "details": "Agarwal & Triggs pose/silhouette data."},
    "boston_housing": {"urls": ["http://archive.ics.uci.edu/ml/machine-learning-databases/housing/"], "files": [["Index", "housing.data", "housing.names"]], "details": "UCI Boston housing prices."},
    "boxjenkins_airline": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/boxjenkins_airline/"], "files": [["boxjenkins_airline.csv"]], "details": "Box & Jenkins monthly airline passengers."},
    "brendan_faces": {"urls": ["http://www.cs.nyu.edu/~roweis/data/"], "files": [["frey_rawface.mat"]], "details": "Brendan Frey face video frames."},
    "cifar-10": {"urls": ["http://www.cs.toronto.edu/~kriz/"], "files": [["cifar-10-python.tar.gz"]], "details": "CIFAR-10 tiny images."},
    "cmu_mocap_full": {"urls": ["http://mocap.cs.cmu.edu/subjects"], "files": [["allasfamc.zip"]], "details": "CMU motion-capture database."},
    "creep_rupture": {"urls": ["http://www.msm.cam.ac.uk/map/data/tar/"], "files": [["creeprupt.tar"]], "details": "Materials Algorithm Project creep-rupture data."},
    "decampos_characters": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/decampos_digits/"], "files": [["characters.npy", "digits.npy"]], "details": "de Campos handwritten characters."},
    "della_gatta": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/della_gatta/"], "files": [["DellaGattadata.mat"]], "details": "Della Gatta TRP63 gene expression time series."},
    "drosophila_protein": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/drosophila_protein/"], "files": [["becker_et_al.csv"]], "details": "Becker et al. Drosophila protein expression."},
    "football_data": {"urls": ["http://www.football-data.co.uk/mmz4281/"], "files": [["E0.csv", "E1.csv", "E2.csv", "E3.csv"]], "details": "English league football results."},
    "fruitfly_tomancak": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/fruitfly_tomancak/"], "files": [["tomancak_exprs.csv", "tomancak_se.csv", "tomancak_prctile5.csv", "tomancak_prctile25.csv", "tomancak_prctile50.csv", "tomancak_prctile75.csv", "tomancak_prctile95.csv"]], "details": "Tomancak Drosophila embryogenesis expression."},
    "global_temperature": {"urls": ["https://www.ncdc.noaa.gov/"], "files": [["GLBTS.long.data"]], "details": "Global average temperature series."},
    "hapmap3": {"urls": ["http://hapmap.ncbi.nlm.nih.gov/downloads/genotypes/latest_phaseIII_ncbi_b36/plink_format/"], "files": [["hapmap3_r2_b36_fwd.consensus.qc.poly.map.bz2", "hapmap3_r2_b36_fwd.consensus.qc.poly.ped.bz2", "relationships_w_pops_121708.txt"]], "details": "HapMap phase III SNP genotypes."},
    "isomap_face_data": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/isomap_face_data/"], "files": [["face_data.mat"]], "details": "Isomap rendered face images."},
    "lee_yeast_ChIP": {"urls": ["http://jura.wi.mit.edu/young_public/regulatory_network/"], "files": [["binding_by_gene.tsv"]], "details": "Lee et al. yeast ChIP-chip binding."},
    "mauna_loa": {"urls": ["ftp://aftp.cmdl.noaa.gov/products/trends/co2/"], "files": [["co2_mm_mlo.txt"]], "details": "Mauna Loa monthly atmospheric CO2."},
    "olivetti_faces": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/olivetti_faces/", "http://www.cs.nyu.edu/~roweis/data/"], "files": [["att_faces.zip"], ["olivettifaces.mat"]], "details": "AT&T/Olivetti face images."},
    "olivetti_glasses": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/olivetti_faces/", "http://www.cs.nyu.edu/~roweis/data/"], "files": [["has_glasses.np"], ["olivettifaces.mat"]], "details": "Olivetti faces with glasses labels."},
    "olympic_marathon_men": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/olympic_marathon_men/"], "files": [["olympicMarathonTimes.csv"]], "details": "Olympic marathon winning paces."},
    "osu_run1": {"urls": ["http://accad.osu.edu/research/mocap/data/", "http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/stick/"], "files": [["run1TXT.ZIP"], ["connections.txt"]], "details": "OSU ACCAD run motion capture."},
    "osu_accad": {"urls": ["http://accad.osu.edu/research/mocap/data/", "http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/stick/"], "files": [["swagger1TXT.ZIP", "handspring1TXT.ZIP", "quickwalkTXT.ZIP", "run1TXT.ZIP", "sprintTXT.ZIP", "dogwalkTXT.ZIP", "camper_04TXT.ZIP", "dance_KB3_TXT.ZIP", "per20_TXT.ZIP", "perTWO07_TXT.ZIP", "perTWO13_TXT.ZIP", "perTWO14_TXT.ZIP", "perTWO15_TXT.ZIP", "perTWO16_TXT.ZIP"], ["connections.txt"]], "details": "OSU ACCAD motion-capture collection."},
    "pumadyn-32nm": {"urls": ["ftp://ftp.cs.toronto.edu/pub/neuron/delve/data/tarfiles/pumadyn-family/"], "files": [["pumadyn-32nm.tar.gz"]], "details": "DELVE pumadyn robot-arm dynamics."},
    "ripley_prnn_data": {"urls": ["http://www.stats.ox.ac.uk/pub/PRNN/"], "files": [["Cushings.dat", "README", "crabs.dat", "fglass.dat", "fglass.grp", "pima.te", "pima.tr", "pima.tr2", "synth.te", "synth.tr", "viruses.dat", "virus3.dat"]], "details": "Ripley PRNN datasets."},
    "robot_wireless": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/robot_wireless/"], "files": [["uw-floor.txt"]], "details": "WiFi signal strengths on a building tour."},
    "rogers_girolami_data": {"urls": ["https://www.dropbox.com/sh/7p6tu1t29idgliq/_XqlH_3nt9/"], "files": [["firstcoursemldata.tar.gz"]], "details": "Rogers & Girolami book datasets (olympics)."},
    "singlecell": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/singlecell/"], "files": [["singlecell.csv"]], "details": "Guo et al. single-cell qPCR."},
    "singlecell_islam": {"urls": ["ftp://ftp.ncbi.nlm.nih.gov/geo/series/GSE29nnn/GSE29087/suppl/"], "files": [["GSE29087_L139_expression_tab.txt.gz"]], "details": "Islam et al. single-cell RNA-seq."},
    "singlecell_deng": {"urls": ["ftp://ftp.ncbi.nlm.nih.gov/geo/series/GSE45nnn/GSE45719/matrix/"], "files": [["GSE45719_series_matrix.txt.gz"]], "details": "Deng et al. single-cell RNA-seq."},
    "sod1_mouse": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/sod1_mouse/"], "files": [["sod1_C57_129_exprs.csv", "sod1_C57_129_se.csv"]], "details": "SOD1 mouse gene expression."},
    "spellman_yeast": {"urls": ["http://genome-www.stanford.edu/cellcycle/data/rawdata/"], "files": [["combined.txt"]], "details": "Spellman yeast cell-cycle microarrays."},
    "swiss_roll": {"urls": ["http://isomap.stanford.edu/"], "files": [["swiss_roll_data.mat"]], "details": "Swiss-roll manifold points."},
    "three_phase_oil_flow": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/three_phase_oil_flow/"], "files": [["DataTrnLbls.txt", "DataTrn.txt", "DataTst.txt", "DataTstLbls.txt", "DataVdn.txt", "DataVdnLbls.txt"]], "details": "Bishop & James three-phase oil flow."},
    "xw_pen": {"urls": ["http://staffwww.dcs.shef.ac.uk/people/N.Lawrence/dataset_mirror/xw_pen/"], "files": [["xw_pen_15.csv"]], "details": "Pen-tip trajectory data."},
}


# --- generic machinery -------------------------------------------------------

def data_available(dataset_name):
    """True iff every registered file for the dataset is in the cache."""
    res = data_resources[dataset_name]
    for filelist in res["files"]:
        for f in filelist:
            if not os.path.exists(os.path.join(data_path(), dataset_name, f)):
                return False
    return True


def download_data(dataset_name):
    """The port reads only local files: a dataset missing from the cache
    raises DatasetNotAvailable naming its source and the files to place
    under data_path()/<dataset_name>/."""
    if dataset_name not in data_resources:
        raise ValueError(f"unknown dataset {dataset_name!r}")
    res = data_resources[dataset_name]
    files = [f for filelist in res["files"] for f in filelist]
    raise DatasetNotAvailable(
        f"dataset {dataset_name!r} is not in the local cache "
        f"{os.path.join(data_path(), dataset_name)!r}; fetch {', '.join(files)} from "
        f"{', '.join(res['urls'])} and place them there")


def _require(dataset_name):
    """Cache dir for a dataset; DatasetNotAvailable when it is absent."""
    if not data_available(dataset_name):
        download_data(dataset_name)
    return os.path.join(data_path(), dataset_name)


def data_details_return(data, data_set):
    """Attach registry details/citation to a loader's dict (GPy :232)."""
    if data_set in data_resources:
        data.update({k: v for k, v in data_resources[data_set].items()
                     if k not in data})
    return data


def sample_class(f):
    """+1/-1 sample from probability f (GPy datasets.py:324)."""
    p1 = 1.0 / (1.0 + np.exp(-f))
    return np.where(np.random.rand(*np.shape(p1)) < p1, 1.0, -1.0)


# --- regression / classification tables -------------------------------------

def boston_housing(data_set="boston_housing"):
    path = _require(data_set)
    all_data = np.fromfile(os.path.join(path, "housing.data"), sep=" ").reshape(-1, 14)
    return data_details_return({"X": all_data[:, :13], "Y": all_data[:, 13:14]}, data_set)


def ripley_synth(data_set="ripley_prnn_data"):
    path = _require(data_set)
    train = np.genfromtxt(os.path.join(path, "synth.tr"), skip_header=1)
    test = np.genfromtxt(os.path.join(path, "synth.te"), skip_header=1)
    return data_details_return({
        "X": train[:, 0:2], "Y": train[:, 2:3],
        "Xtest": test[:, 0:2], "Ytest": test[:, 2:3],
        "info": "Ripley synthetic two-class problem."}, data_set)


def oil(data_set="three_phase_oil_flow"):
    """Bishop & James three-phase oil flow; labels mapped to +-1 triplets."""
    path = _require(data_set)

    def mat(name, cols):
        return np.fromfile(os.path.join(path, name), sep="\t").reshape(-1, cols)

    out = {
        "X": mat("DataTrn.txt", 12), "Y": mat("DataTrnLbls.txt", 3) * 2.0 - 1.0,
        "Xtest": mat("DataTst.txt", 12), "Ytest": mat("DataTstLbls.txt", 3) * 2.0 - 1.0,
        "Xvalid": mat("DataVdn.txt", 12), "Yvalid": mat("DataVdnLbls.txt", 3) * 2.0 - 1.0,
    }
    return data_details_return(out, data_set)


def oil_100(seed=default_seed, data_set="three_phase_oil_flow"):
    data = oil()
    rng = np.random.default_rng(seed)
    idx = rng.permutation(data["X"].shape[0])[:100]
    return data_details_return(
        {"X": data["X"][idx], "Y": data["Y"][idx],
         "info": f"100-point random subsample of the oil data (seed {seed})"}, data_set)


def pumadyn(seed=default_seed, data_set="pumadyn-32nm"):
    path = _require(data_set)
    inner = os.path.join(path, "pumadyn-32nm", "Dataset.data.gz")
    if not os.path.exists(inner):
        with tarfile.open(os.path.join(path, "pumadyn-32nm.tar.gz")) as tar:
            tar.extractall(path)
    data = np.loadtxt(inner)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(data.shape[0])
    n_train = 7168
    tr, te = perm[:n_train], perm[n_train:]
    return data_details_return({
        "X": data[tr, :-1], "Y": data[tr, -1:],
        "Xtest": data[te, :-1], "Ytest": data[te, -1:],
        "seed": seed}, data_set)


def creep_data(data_set="creep_rupture"):
    path = _require(data_set)
    inner = os.path.join(path, "taka")
    if not os.path.exists(inner):
        with tarfile.open(os.path.join(path, "creeprupt.tar")) as tar:
            tar.extractall(path)
    all_data = np.loadtxt(inner)
    y = all_data[:, 1:2].copy()
    features = [0] + list(range(2, 31))
    X = all_data[:, features].copy()
    return data_details_return({"X": X, "y": y, "Y": y}, data_set)


def robot_wireless(data_set="robot_wireless"):
    """WiFi strengths around a building tour: Y = per-access-point strength
    matrix over time, X = 2-D position; first 215 rows train."""
    path = _require(data_set)
    fn = os.path.join(path, "uw-floor.txt")
    all_time = np.genfromtxt(fn, usecols=(0,))
    mac = np.genfromtxt(fn, usecols=(1,), dtype=str)
    x = np.genfromtxt(fn, usecols=(2,))
    y = np.genfromtxt(fn, usecols=(3,))
    strength = np.genfromtxt(fn, usecols=(4,))
    addresses = np.unique(mac); addresses.sort()
    times = np.unique(all_time); times.sort()
    addr_idx = {a: j for j, a in enumerate(addresses)}
    time_idx = {t: i for i, t in enumerate(times)}
    allY = np.full((len(times), len(addresses)), -92.0)
    allX = np.zeros((len(times), 2))
    for t, a, xi, yi, s in zip(all_time, mac, x, y, strength):
        i, j = time_idx[t], addr_idx[a]
        allY[i, j] = s
        allX[i] = (xi, yi)
    allY = (allY + 85.0) / 15.0
    return data_details_return({
        "X": allX[:215], "Y": allY[:215], "Xtest": allX[215:], "Ytest": allY[215:],
        "addresses": addresses, "times": times}, data_set)


def xw_pen(data_set="xw_pen"):
    path = _require(data_set)
    data = np.loadtxt(os.path.join(path, "xw_pen_15.csv"), delimiter=",")
    return data_details_return(
        {"Y": data[:, 1:3], "X": np.arange(data.shape[0])[:, None],
         "info": "pen-tip trajectory, 15th sample"}, data_set)


# --- time series -------------------------------------------------------------

def _noaa_style_series(path, fname, num_train):
    data = np.loadtxt(path if fname is None else os.path.join(path, fname))
    keep = data[:, 3] != -99.99
    allX, allY = data[keep, 2:3], data[keep, 3:4]
    return {"X": allX[:num_train], "Y": allY[:num_train],
            "Xtest": allX[num_train:], "Ytest": allY[num_train:]}


def mauna_loa(data_set="mauna_loa", num_train=545, refresh_data=False):
    path = _require(data_set)
    out = _noaa_style_series(path, "co2_mm_mlo.txt", num_train)
    out["info"] = f"Mauna Loa CO2 with {num_train} training points"
    return data_details_return(out, data_set)


def global_average_temperature(data_set="global_temperature", num_train=1000, refresh_data=False):
    path = _require(data_set)
    out = _noaa_style_series(path, "GLBTS.long.data", num_train)
    out["info"] = f"global average temperature with {num_train} training points"
    return data_details_return(out, data_set)


def boxjenkins_airline(data_set="boxjenkins_airline", num_train=96):
    path = _require(data_set)
    data = np.loadtxt(os.path.join(path, "boxjenkins_airline.csv"), delimiter=",")
    return data_details_return({
        "X": data[:num_train, 0:1], "Y": data[:num_train, 1:2],
        "Xtest": data[num_train:, 0:1], "Ytest": data[num_train:, 1:2],
        "info": "Box & Jenkins monthly airline passengers"}, data_set)


# --- olympics (Rogers & Girolami) --------------------------------------------

def download_rogers_girolami_data(data_set="rogers_girolami_data"):
    path = _require(data_set)
    inner = os.path.join(path, "firstcoursemldata", "olympics.mat")
    if not os.path.exists(inner):
        with tarfile.open(os.path.join(path, "firstcoursemldata.tar.gz")) as tar:
            tar.extractall(path)
    import scipy.io

    return scipy.io.loadmat(inner)


def _olympic_event(key, data_set="rogers_girolami_data"):
    mat = download_rogers_girolami_data(data_set)
    arr = np.asarray(mat[key], dtype=float)
    return data_details_return(
        {"X": arr[:, 0:1], "Y": arr[:, 1:2], "info": key}, data_set)


def olympic_100m_men():
    return _olympic_event("male100")


def olympic_100m_women():
    return _olympic_event("female100")


def olympic_200m_men():
    return _olympic_event("male200")


def olympic_200m_women():
    return _olympic_event("female200")


def olympic_400m_men():
    return _olympic_event("male400")


def olympic_400m_women():
    return _olympic_event("female400")


def olympic_sprints(data_set="rogers_girolami_data"):
    """All six sprint events stacked with an output-index column
    (coregionalized-regression demo format, GPy datasets.py:1257)."""
    keys = ["male100", "female100", "male200", "female200", "male400", "female400"]
    mat = download_rogers_girolami_data(data_set)
    X_list, Y_list = [], []
    for i, k in enumerate(keys):
        arr = np.asarray(mat[k], dtype=float)
        X_list.append(np.hstack([arr[:, 0:1], np.full((arr.shape[0], 1), float(i))]))
        Y_list.append(arr[:, 1:2])
    return data_details_return({
        "X": np.vstack(X_list), "Y": np.vstack(Y_list),
        "output_info": dict(enumerate(keys)),
        "info": "olympic sprint winning times, output index in X[:, 1]"}, data_set)


def olympic_marathon_men(data_set="olympic_marathon_men"):
    """Olympic marathon pace. Falls back to a clearly-marked synthetic
    stand-in when the cache is absent (offline CI environments)."""
    fpath = os.path.join(data_path(), data_set, "olympicMarathonTimes.csv")
    if os.path.exists(fpath):
        data = np.genfromtxt(fpath, delimiter=",")
        return data_details_return(
            {"X": data[:, 0:1], "Y": data[:, 1:2]}, data_set)
    rng = np.random.default_rng(1896)
    years = np.arange(1896, 2016, 4.0)
    years = np.delete(years, [4, 11, 12])  # war years
    X = years.reshape(-1, 1)
    pace = 5.2 - 2.0 * (1 - np.exp(-(X - 1896) / 50.0)) + 0.08 * rng.standard_normal(X.shape)
    return {"X": X, "Y": pace, "info": "SYNTHETIC stand-in for olympic marathon men"}


# --- biology -----------------------------------------------------------------

def della_gatta_TRP63_gene_expression(data_set="della_gatta", gene_number=None):
    import scipy.io

    path = _require(data_set)
    mat = scipy.io.loadmat(os.path.join(path, "DellaGattadata.mat"))
    X = np.double(mat["timepoints"])
    Y = mat["exprs_tp53_RMA"] if gene_number is None else mat["exprs_tp53_RMA"][:, gene_number][:, None]
    return data_details_return({"X": X, "Y": Y, "gene_number": gene_number}, data_set)


def spellman_yeast(data_set="spellman_yeast"):
    import pandas as pd

    path = _require(data_set)
    Y = pd.read_csv(os.path.join(path, "combined.txt"), index_col=0, sep="\t")
    return data_details_return({"Y": Y, "info": "Spellman yeast cell cycle (all experiments)"}, data_set)


def spellman_yeast_cdc15(data_set="spellman_yeast"):
    data = spellman_yeast(data_set)
    Y = data["Y"]
    t = np.asarray([10, 30, 50, 70, 80, 90, 100, 110, 120, 130, 140, 150,
                    170, 180, 190, 200, 210, 220, 230, 240, 250, 270, 290], dtype=float)
    cols = [f"cdc15_{int(ti)}" for ti in t]
    Ycdc = Y[[c for c in cols if c in Y.columns]]
    return data_details_return({
        "Y": Ycdc, "t": t[:Ycdc.shape[1]],
        "info": "Spellman yeast cdc15 experiment timepoints"}, data_set)


def lee_yeast_ChIP(data_set="lee_yeast_ChIP"):
    import pandas as pd

    path = _require(data_set)
    df = pd.read_csv(os.path.join(path, "binding_by_gene.tsv"), sep="\t", header=[0, 1])
    return data_details_return({"Y": df, "info": "Lee et al. ChIP binding by gene"}, data_set)


def fruitfly_tomancak(data_set="fruitfly_tomancak", gene_number=None):
    import pandas as pd

    path = _require(data_set)
    exprs = pd.read_csv(os.path.join(path, "tomancak_exprs.csv"), index_col=0)
    se = pd.read_csv(os.path.join(path, "tomancak_se.csv"), index_col=0)
    return data_details_return({"Y": exprs, "se": se, "gene_number": gene_number}, data_set)


def drosophila_protein(data_set="drosophila_protein"):
    import pandas as pd

    path = _require(data_set)
    Y = pd.read_csv(os.path.join(path, "becker_et_al.csv"), index_col=0)
    return data_details_return({"Y": Y}, data_set)


def drosophila_knirps(data_set="drosophila_protein"):
    data = drosophila_protein(data_set)
    Y = data["Y"]
    cols = [c for c in Y.columns if "kni" in c.lower() or c in ("t", "x")]
    return data_details_return({"Y": Y[cols] if cols else Y,
                                "info": "knirps protein/mRNA columns"}, data_set)


def sod1_mouse(data_set="sod1_mouse"):
    import pandas as pd

    path = _require(data_set)
    exprs = pd.read_csv(os.path.join(path, "sod1_C57_129_exprs.csv"), index_col=0)
    se = pd.read_csv(os.path.join(path, "sod1_C57_129_se.csv"), index_col=0)
    return data_details_return({"Y": exprs, "se": se}, data_set)


def singlecell(data_set="singlecell"):
    import pandas as pd

    path = _require(data_set)
    Y = pd.read_csv(os.path.join(path, "singlecell.csv"), index_col=0)
    labels = Y.index.to_numpy()
    return data_details_return({"Y": Y, "info": "Guo et al. single-cell qPCR",
                                "labels": labels}, data_set)


def singlecell_rna_seq_islam(dataset="singlecell_islam"):
    import gzip
    import pandas as pd

    path = _require(dataset)
    with gzip.open(os.path.join(path, "GSE29087_L139_expression_tab.txt.gz"), "rt") as f:
        Y = pd.read_csv(f, sep="\t", index_col=0, skiprows=6, header=None)
    return data_details_return({"Y": Y, "info": "Islam et al. scRNA-seq counts"}, dataset)


def singlecell_rna_seq_deng(dataset="singlecell_deng"):
    import gzip
    import pandas as pd

    path = _require(dataset)
    with gzip.open(os.path.join(path, "GSE45719_series_matrix.txt.gz"), "rt") as f:
        lines = [l for l in f if not l.startswith("!")]
    from io import StringIO

    Y = pd.read_csv(StringIO("".join(lines)), sep="\t", index_col=0)
    return data_details_return({"Y": Y, "info": "Deng et al. scRNA-seq series matrix"}, dataset)


def hapmap3(data_set="hapmap3"):
    """HapMap phase III genotypes. The reference's loader (datasets.py:776)
    runs a 150-line plink-format recoding pipeline; that preprocessing is
    out of scope offline — the registry entry enables the download and this
    raises with instructions when the recoded cache is missing."""
    path = os.path.join(data_path(), data_set)
    cached = os.path.join(path, "preprocessed_data.npz")
    if os.path.exists(cached):
        arr = np.load(cached)
        return data_details_return(dict(arr), data_set)
    raise DatasetNotAvailable(
        f"hapmap3 needs the plink-format files recoded into {cached!r}; "
        f"sources: {data_resources[data_set]['urls']}")


def football_data(season="1314", data_set="football_data"):
    """League football results; X = [division, home team id, away team id],
    Y = [home goals, away goals]."""
    import pandas as pd

    path = _require(data_set)
    frames = []
    for div, f in enumerate(["E0.csv", "E1.csv", "E2.csv", "E3.csv"]):
        df = pd.read_csv(os.path.join(path, f))
        df["Division"] = div
        frames.append(df)
    data = pd.concat(frames, ignore_index=True)
    teams = {t: i for i, t in enumerate(sorted(set(data["HomeTeam"]) | set(data["AwayTeam"])))}
    X = np.stack([data["Division"].to_numpy(),
                  data["HomeTeam"].map(teams).to_numpy(),
                  data["AwayTeam"].map(teams).to_numpy()], axis=1).astype(float)
    Y = data[["FTHG", "FTAG"]].to_numpy(dtype=float)
    return data_details_return({"X": X, "Y": Y, "teams": teams, "season": season}, data_set)


def google_trends(query_terms=("big data", "machine learning", "data science"),
                  data_set="google_trends", refresh_data=False):
    raise DatasetNotAvailable(
        "google_trends requires live access to the Google Trends API "
        "(the reference scrapes it at call time; no offline cache format).")


# --- images / vision ----------------------------------------------------------

def brendan_faces(data_set="brendan_faces"):
    import scipy.io

    path = _require(data_set)
    mat = scipy.io.loadmat(os.path.join(path, "frey_rawface.mat"))
    Y = mat["ff"].T
    return data_details_return({"Y": Y}, data_set)


def olivetti_faces(data_set="olivetti_faces"):
    """AT&T faces: 400 92x112 PGM images (parsed with the package's netpbm
    reader) -> Y (400, 10304), one row per image."""
    # only att_faces.zip is needed (the .mat in the registry is the
    # alternate mirror used by olivetti_glasses)
    path = os.path.join(data_path(), data_set)
    if not os.path.exists(os.path.join(path, "att_faces.zip")):
        download_data(data_set)
    zip_path = os.path.join(path, "att_faces.zip")
    extracted = os.path.join(path, "att_faces")
    if not os.path.isdir(extracted):
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(extracted)
    from .netpbmfile import imread

    rows, labels = [], []
    for subj in range(1, 41):
        for img in range(1, 11):
            p = os.path.join(extracted, f"s{subj}", f"{img}.pgm")
            if not os.path.exists(p):
                p = os.path.join(extracted, "orl_faces", f"s{subj}", f"{img}.pgm")
            rows.append(np.asarray(imread(p), dtype=float).ravel())
            labels.append(subj)
    return data_details_return(
        {"Y": np.stack(rows), "lbls": np.asarray(labels)[:, None]}, data_set)


def olivetti_glasses(data_set="olivetti_glasses", num_training=200, seed=default_seed):
    import pickle
    import scipy.io

    path = _require(data_set)
    with open(os.path.join(path, "has_glasses.np"), "rb") as f:
        has_glasses = pickle.load(f)
    y = np.where(np.asarray(has_glasses) == "y", 1.0, 0.0)[:, None]
    mat = scipy.io.loadmat(os.path.join(path, "olivettifaces.mat"))
    Y = mat["faces"].T
    rng = np.random.default_rng(seed)
    index = rng.permutation(Y.shape[0])
    itr, ite = index[:num_training], index[num_training:]
    return data_details_return({
        "X": Y[itr], "Y": y[itr], "Xtest": Y[ite], "Ytest": y[ite],
        "seed": seed, "info": "glasses-detection split of Olivetti faces"}, data_set)


def decampos_digits(data_set="decampos_characters", which_digits=tuple(range(10))):
    path = _require(data_set)
    digits = np.load(os.path.join(path, "digits.npy"))
    digits = digits[list(which_digits), :, :, :]
    n_cls, n_samp, h, w = digits.shape
    Y = digits.reshape(n_cls * n_samp, h * w)
    lbls = np.repeat(np.asarray(which_digits), n_samp)[:, None]
    return data_details_return({
        "Y": Y, "lbls": lbls,
        "str_lbls": lbls.astype(str),
        "info": "de Campos digits"}, data_set)


def cifar10_patches(data_set="cifar-10"):
    """1000 random 5x5 color patches from the first CIFAR-10 batch
    (GPy datasets.py:1379 semantics)."""
    import pickle

    path = _require(data_set)
    inner = os.path.join(path, "cifar-10-batches-py", "data_batch_1")
    if not os.path.exists(inner):
        with tarfile.open(os.path.join(path, "cifar-10-python.tar.gz")) as tar:
            tar.extractall(path)
    with open(inner, "rb") as f:
        batch = pickle.load(f, encoding="latin1")
    images = batch["data"].reshape(-1, 3, 32, 32)
    rng = np.random.default_rng(default_seed)
    patches = []
    for _ in range(1000):
        i = rng.integers(images.shape[0])
        r, c = rng.integers(0, 28, size=2)
        patches.append(images[i, :, r:r + 5, c:c + 5].ravel())
    return data_details_return(
        {"Y": np.stack(patches).astype(float) / 255.0,
         "info": "1000 random 5x5 RGB patches from CIFAR-10 batch 1"}, data_set)


def silhouette(data_set="ankur_pose_data"):
    import scipy.io

    path = _require(data_set)
    mat = scipy.io.loadmat(os.path.join(path, "ankurDataPoseSilhouette.mat"))
    mu, sd = np.mean(mat["Y"]), np.sqrt(np.var(mat["Y"]))
    return data_details_return({
        "X": (mat["Y"] - mu) / sd, "Y": mat["Z"],
        "Xtest": (mat["Y_test"] - mu) / sd, "Ytest": mat["Z_test"]}, data_set)


def isomap_faces(num_samples=698, data_set="isomap_face_data"):
    import scipy.io

    path = _require(data_set)
    mat = scipy.io.loadmat(os.path.join(path, "face_data.mat"))
    Y = mat["images"].T[:num_samples]
    return data_details_return({
        "Y": Y, "poses": mat.get("poses"), "lights": mat.get("lights"),
        "info": "Isomap rendered faces"}, data_set)


# --- manifolds / mocap ---------------------------------------------------------

def swiss_roll_generated(num_samples=1000, sigma=0.0):
    """Analytic swiss roll (no download). GPy datasets.py:762."""
    rng = np.random.default_rng(default_seed)
    t = 1.5 * np.pi * (1.0 + 2.0 * rng.random(num_samples))
    h = 30.0 * rng.random(num_samples)
    Y = np.stack([t * np.cos(t), h, t * np.sin(t)], axis=1)
    Y += sigma * rng.standard_normal(Y.shape)
    return {"Y": Y, "t": t, "h": h, "info": "generated swiss roll"}


def swiss_roll(num_samples=3000, data_set="swiss_roll"):
    import scipy.io

    path = _require(data_set)
    mat = scipy.io.loadmat(os.path.join(path, "swiss_roll_data.mat"))
    Y = mat["X_data"].T[:num_samples]
    return data_details_return({"Y": Y, "info": "Stanford swiss roll points"}, data_set)


def swiss_roll_1000():
    return swiss_roll(num_samples=1000)


def osu_run1(data_set="osu_run1", sample_every=4):
    from . import mocap

    path = _require(data_set)
    zip_path = os.path.join(path, "run1TXT.ZIP")
    stick = os.path.join(path, "run1TXT")
    if not os.path.isdir(stick):
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(path)
        stick = path
    # the zip contains <take>.txt; reuse the reference's take name when present
    candidates = [f[:-4] for f in os.listdir(path) if f.lower().endswith(".txt")
                  and f.lower() != "connections.txt"]
    take = "Aug210106" if "Aug210106" in candidates else (candidates[0] if candidates else "Aug210106")
    Y, connect = mocap.load_text_data(take, path)
    return data_details_return(
        {"Y": Y[0:-1:sample_every, :], "connect": connect}, data_set)


def cmu_urls_files(subj_motions, messages=True):
    """(urls, files) needed from mocap.cs.cmu.edu for given (subjects,
    motions) pairs. GPy datasets.py:238."""
    subjects, motions = subj_motions
    urls, files = [], []
    base = "http://mocap.cs.cmu.edu/subjects"
    for subj, mots in zip(subjects, motions):
        s = f"{int(subj):02d}"
        urls.append(f"{base}/{s}/")
        fl = [f"{s}.asf"] + [f"{s}_{int(m):02d}.amc" for m in mots]
        files.append(fl)
    return urls, files


def cmu_mocap(subject, train_motions, test_motions=(), sample_every=4,
              data_set="cmu_mocap"):
    """CMU motion capture for one subject: channels from ASF/AMC via
    gpy_tpu_torch.util.mocap (GPy datasets.py:1423)."""
    from . import mocap

    s = f"{int(subject):02d}"
    path = os.path.join(data_path(), data_set)
    asf = os.path.join(path, f"{s}.asf")
    if not os.path.exists(asf):
        urls, files = cmu_urls_files(([subject], [list(train_motions) + list(test_motions)]))
        raise DatasetNotAvailable(
            f"cmu_mocap subject {s} not cached at {path!r}; fetch {files} from {urls}")
    skel = mocap.acclaim_skeleton(asf)
    def chans(motions):
        out = []
        for m in motions:
            amc = os.path.join(path, f"{s}_{int(m):02d}.amc")
            out.append(skel.load_channels(amc)[::sample_every])
        return np.vstack(out) if out else np.zeros((0, 0))
    Y = chans(train_motions)
    Ytest = chans(test_motions)
    return data_details_return({
        "Y": Y, "Ytest": Ytest, "skel": skel,
        "info": f"CMU mocap subject {s}"}, data_set)


def cmu_mocap_49_balance(data_set="cmu_mocap"):
    """Subject 49 balancing motions 18, 19 (train) / 20 (test)."""
    return cmu_mocap(49, [18, 19], [20], sample_every=4, data_set=data_set)


def cmu_mocap_35_walk_jog(data_set="cmu_mocap"):
    """Subject 35 walk/jog motions (the GPLVM benchmark split)."""
    train = list(range(1, 17)) + list(range(19, 27)) + [28, 30, 31, 32, 34]
    test = [18, 29, 33]
    return cmu_mocap(35, train, test, sample_every=4, data_set=data_set)


# --- synthetic generators (always offline) ------------------------------------

def toy_rbf_1d(seed=default_seed, num_samples=500, noise=0.05):
    """Sample from a known RBF GP (GPy datasets.py:1110)."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.random((num_samples, 1)) * 6, axis=0)
    d2 = (X - X.T) ** 2
    K = np.exp(-0.5 * d2 / 0.7**2) + noise * np.eye(num_samples)
    Y = np.linalg.cholesky(K) @ rng.standard_normal((num_samples, 1))
    return {"X": X, "Y": Y, "info": "samples from an RBF(l=0.7) GP + noise"}


def toy_rbf_1d_50(seed=default_seed):
    data = toy_rbf_1d(seed, num_samples=500)
    idx = np.random.default_rng(seed).permutation(500)[:50]
    idx.sort()
    return {"X": data["X"][idx], "Y": data["Y"][idx],
            "info": "50-point subsample of toy_rbf_1d"}


def toy_linear_1d_classification(seed=default_seed, n=100):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(-1.0, 0.5, (n // 2, 1))
    x2 = rng.normal(1.0, 0.5, (n - n // 2, 1))
    X = np.vstack([x1, x2])
    Y = np.vstack([np.zeros((n // 2, 1)), np.ones((n - n // 2, 1))])
    return {"X": X, "Y": Y, "info": "two 1-D Gaussian clusters"}


def crescent_data(num_data=200, seed=default_seed):
    """Two interleaved crescents (GPy datasets.py:1321 shape)."""
    rng = np.random.default_rng(seed)
    n = num_data
    t1 = rng.random(n // 2) * np.pi
    t2 = rng.random(n - n // 2) * np.pi
    X1 = np.stack([np.cos(t1), np.sin(t1)], 1) + 0.15 * rng.standard_normal((n // 2, 2))
    X2 = np.stack([1 - np.cos(t2), 0.5 - np.sin(t2)], 1) + 0.15 * rng.standard_normal((n - n // 2, 2))
    X = np.vstack([X1, X2])
    Y = np.vstack([np.ones((n // 2, 1)), -np.ones((n - n // 2, 1))])
    return {"X": X, "Y": Y, "info": "two crescents"}


def oil_synthetic(seed=0, n=300):
    """Offline stand-in for the oil-flow dataset (3 classes, 12-D)."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, 2))
    labels = rng.integers(0, 3, n)
    centers = rng.standard_normal((3, 2)) * 2
    Zc = Z * 0.5 + centers[labels]
    W = rng.standard_normal((2, 12))
    X = np.tanh(Zc @ W) + 0.05 * rng.standard_normal((n, 12))
    return {"X": X, "Y": labels.reshape(-1, 1), "info": "SYNTHETIC 3-class 12-D manifold"}


def simulation_BGPLVM(seed=0, n=100, q_true=3, d=10):
    """Latent-manifold simulation (GPy datasets.py:1100)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, q_true))
    W = rng.standard_normal((q_true, d))
    Y = np.sin(X) @ W + 0.05 * rng.standard_normal((n, d))
    return {"X": X, "Y": Y, "info": f"nonlinear map from {q_true} latent dims"}
