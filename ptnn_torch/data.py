"""Dataset loaders and preprocessing.

The port's own copy of ``ptnn/data.py`` (same names, NumPy float64 rows).
The digits loader reads ``classification/digits.csv.gz`` under the data root
with gzip and numpy (``ptnn`` asks scikit-learn for the same file). The data
root is ``<repo>/data`` unless ``PTNN_DATA`` names another.

Bundles the reference's problem suite (SURVEY.md §L7). Regression sets are the
4-lag Takens-embedding one-step-ahead series
(multicore-pt-regression/Data_OneStepAhead/*/{train,test}.txt, rows =
``[x1..x4, y]``). Classification sets reproduce the per-problem blocks of
``main()`` (multicore-pt-classification/pt_classification.py:899-1012):
z-score normalization per feature and a random 70/30 split for the combined
sets, with the same label transformations the reference's offline preprocess
scripts apply (DATA/Cancer/preprocess_cancer.py, DATA/Ions/Ions/
preprocess_ions.py, DATA/Bank/preprocess.py, DATA/TicTac/preprocess_ttt.py).

Row format everywhere: ``[features..., label]`` float matrix.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# repo-relative by default; PTNN_DATA overrides for installed deployments
_ROOT = os.environ.get(
    "PTNN_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"),
)

REGRESSION_SETS = (
    "Lazer",
    "Sunspot",
    "Mackey",
    "Lorenz",
    "Rossler",
    "Henon",
    "ACFinance",
)

# topology blocks of pt_classification.py:899-995: name -> (ip, hidden, output)
CLASSIFICATION_TOPOLOGIES: Dict[str, Tuple[int, int, int]] = {
    "iris": (4, 12, 3),
    "Ionosphere": (34, 50, 2),
    "Cancer": (9, 12, 2),
    "bank-additional": (51, 50, 2),
    "PenDigit": (16, 30, 10),
    "chess": (6, 25, 18),
    # problems 1-2 (pt_classification.py:909-941) + extra bundled sets
    "winequality-red": (11, 50, 10),
    "winequality-white": (11, 50, 10),
    "TicTac": (9, 25, 2),
    "abalone": (8, 30, 29),
}

REGRESSION_TOPOLOGY: Tuple[int, int, int] = (4, 10, 1)  # pt_timeseries_regression.py:915-917


@dataclass
class Problem:
    name: str
    task: str
    topology: Tuple[int, int, int]
    train: np.ndarray
    test: np.ndarray


def data_root() -> str:
    return _ROOT


def load_regression(name: str, root: str | None = None) -> Problem:
    """One-step-ahead series (pt_timeseries_regression.py:877-909)."""
    if name not in REGRESSION_SETS:
        raise KeyError(f"unknown regression set {name!r}; have {REGRESSION_SETS}")
    root = root or _ROOT
    d = os.path.join(root, "Data_OneStepAhead", name)
    train = np.loadtxt(os.path.join(d, "train.txt"))
    test = np.loadtxt(os.path.join(d, "test.txt"))
    return Problem(name, "regression", REGRESSION_TOPOLOGY, train, test)


def zscore_and_split(
    features: np.ndarray,
    classes: np.ndarray,
    rng: np.random.Generator,
    train_ratio: float = 0.7,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-feature z-score + random 70/30 split (pt_classification.py:1003-1012)."""
    feats = features.astype(np.float64).copy()
    for k in range(feats.shape[1]):
        dev = np.std(feats[:, k])
        feats[:, k] = (feats[:, k] - np.mean(feats[:, k])) / dev
    n = feats.shape[0]
    idx = rng.permutation(n)
    cut = int(train_ratio * n)
    both = np.hstack([feats, classes.reshape(-1, 1)])
    return both[idx[:cut]], both[idx[cut:]]


def _bank_processed(root: str) -> np.ndarray:
    """Reproduce DATA/Bank/preprocess.py exactly: min-max scaled numerical
    columns + get_dummies one-hot categoricals + binary label, from raw
    bank.csv."""
    import pandas as pd

    df = pd.read_csv(os.path.join(root, "classification", "Bank", "bank.csv"), sep=";")
    cols_numerical = list(df.select_dtypes(include="number").columns)
    cols_categorical = [
        c for c in df.columns if c not in cols_numerical and c != "y"
    ]
    y = pd.get_dummies(df["y"])["yes"].values.astype("float64")
    X = df[cols_numerical]
    X = (X - X.min(axis=0)) / (X.max(axis=0) - X.min(axis=0))
    for name in cols_categorical:
        X = pd.concat((X, pd.get_dummies(df[name])), axis=1)
    return np.hstack([X.values.astype("float64"), y.reshape(-1, 1)])


def _append_complement(data: np.ndarray) -> np.ndarray:
    """Append the complement of the last column as a new column: rows with
    last == 0 get 1, rows with last == 1 get 0 (two-column one-hot labels).
    Rows with any other value keep the initialized 1 — faithful to the
    reference loops, which only handle the 0/1 cases."""
    out = np.c_[data, np.ones((data.shape[0], 1))]
    out[data[:, -1] == 0, -1] = 1.0
    out[data[:, -1] == 1, -1] = 0.0
    return out


def preprocess_cancer(root: str | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Regenerate Cancer's ftrain/ftest from the raw rtrain/rtest splits:
    append the label complement (last col 1 -> 0, else 1) as in
    DATA/Cancer/preprocess_cancer.py:15-24. Returns (ftrain, ftest).

    Quirk note: the committed script reads the splits SWAPPED
    (preprocess_cancer.py:4-5 assigns testdata from rtrain.txt), which would
    produce a 489-row ftest — but the committed ftest.txt has rtest's 210
    rows, so the committed outputs were generated by the straight mapping
    used here; the script's swap is a later editing bug."""
    croot = os.path.join(root or _ROOT, "classification", "Cancer")
    rtrain = np.genfromtxt(os.path.join(croot, "rtrain.txt"))
    rtest = np.genfromtxt(os.path.join(croot, "rtest.txt"))
    # same label-complement rule as Ions/TicTac (1 -> 0, else -> 1)
    return _append_complement(rtrain), _append_complement(rtest)


def preprocess_ions(root: str | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Regenerate Ions' ftrain/ftest from rtrain/rtest, reproducing
    DATA/Ions/Ions/preprocess_ions.py:1-28 (complement column appended)."""
    croot = os.path.join(root or _ROOT, "classification", "Ions")
    train = np.genfromtxt(os.path.join(croot, "rtrain.txt"))
    test = np.genfromtxt(os.path.join(croot, "rtest.txt"))
    return _append_complement(train), _append_complement(test)


def preprocess_tictac(
    root: str | None = None, rng: np.random.Generator | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Regenerate TicTac's ftrain/ftest from rtrain/rtest, reproducing
    DATA/TicTac/preprocess_ttt.py:1-35 (complement column + row shuffle).
    The reference shuffles with an unseeded global RNG, so ordering is not
    reproducible — pass ``rng`` to seed it; the bundled files match up to a
    row permutation."""
    croot = os.path.join(root or _ROOT, "classification", "TicTac")
    train = _append_complement(np.genfromtxt(os.path.join(croot, "rtrain.txt")))
    test = _append_complement(np.genfromtxt(os.path.join(croot, "rtest.txt")))
    rng = rng or np.random.default_rng()
    rng.shuffle(train)
    rng.shuffle(test)
    return train, test


def load_classification(name: str, seed: int = 0, root: str | None = None) -> Problem:
    """Classification problems as configured in pt_classification.py:899-1012."""
    root = root or _ROOT
    croot = os.path.join(root, "classification")
    rng = np.random.default_rng(seed)

    if name == "iris":  # problem 3
        data = np.genfromtxt(os.path.join(croot, "iris.csv"), delimiter=";")
        classes = data[:, 4] - 1  # labels 1..3 -> 0..2 (pt_classification.py:922)
        train, test = zscore_and_split(data[:, 0:4], classes, rng)
    elif name == "Ionosphere":  # problem 4 — pre-split ftrain/ftest csv
        train = np.genfromtxt(
            os.path.join(croot, "Ions", "ftrain.csv"), delimiter=","
        )[:, :-1]
        test = np.genfromtxt(os.path.join(croot, "Ions", "ftest.csv"), delimiter=",")[
            :, :-1
        ]
    elif name == "Cancer":  # problem 5 — pre-split ftrain/ftest txt
        train = np.genfromtxt(
            os.path.join(croot, "Cancer", "ftrain.txt"), delimiter=" "
        )[:, :-1]
        test = np.genfromtxt(os.path.join(croot, "Cancer", "ftest.txt"), delimiter=" ")[
            :, :-1
        ]
    elif name == "bank-additional":  # problem 6
        data = _bank_processed(root)
        ip = data.shape[1] - 1
        train, test = zscore_and_split(data[:, :ip], data[:, ip], rng)
    elif name == "PenDigit":  # problem 7 — pre-split, z-scored per file
        train = np.genfromtxt(
            os.path.join(croot, "PenDigit", "train.csv"), delimiter=","
        )
        test = np.genfromtxt(os.path.join(croot, "PenDigit", "test.csv"), delimiter=",")
        for mat in (train, test):
            for k in range(16):
                mat[:, k] = (mat[:, k] - np.mean(mat[:, k])) / np.std(mat[:, k])
    elif name in ("winequality-red", "winequality-white"):  # problems 1-2
        data = np.genfromtxt(os.path.join(croot, f"{name}.csv"), delimiter=";")
        data = data[1:, :]  # drop header row (pt_classification.py:933)
        train, test = zscore_and_split(data[:, 0:11], data[:, 11], rng)
    elif name == "TicTac":  # bundled pre-split set (DATA/TicTac, one-hot'd
        # endgame boards + win/lose label via preprocess_ttt.py)
        train = np.genfromtxt(
            os.path.join(croot, "TicTac", "ftrain.csv"), delimiter=","
        )[:, :-1]
        test = np.genfromtxt(os.path.join(croot, "TicTac", "ftest.csv"), delimiter=",")[
            :, :-1
        ]
    elif name == "abalone":  # bundled raw set: sex letter -> {M:0,F:1,I:2},
        # rings (1..29) as the class label
        rows = []
        with open(os.path.join(croot, "abalone.data")) as f:
            for line in f:
                p = line.strip().split(",")
                if len(p) != 9:
                    continue
                sex = {"M": 0.0, "F": 1.0, "I": 2.0}[p[0]]
                rows.append([sex] + [float(v) for v in p[1:8]] + [float(p[8]) - 1.0])
        data = np.asarray(rows)
        train, test = zscore_and_split(data[:, 0:8], data[:, 8], rng)
    elif name == "chess":  # problem 8
        # The reference loads a numeric 'DATA/chess.csv' that is NOT committed
        # (pt_classification.py:986 would fail as shipped); we encode the raw
        # UCI King-Rook-vs-King file the obvious way: file letters a..h -> 1..8,
        # ranks as ints, and the 18 depth-of-win labels draw,zero..sixteen ->
        # 0..17.
        labels = [
            "draw", "zero", "one", "two", "three", "four", "five", "six",
            "seven", "eight", "nine", "ten", "eleven", "twelve", "thirteen",
            "fourteen", "fifteen", "sixteen",
        ]
        lut = {v: i for i, v in enumerate(labels)}
        rows = []
        with open(os.path.join(croot, "chess.data")) as f:
            for line in f:
                p = line.strip().split(",")
                if len(p) != 7:
                    continue
                rows.append(
                    [
                        ord(p[0]) - ord("a") + 1.0, float(p[1]),
                        ord(p[2]) - ord("a") + 1.0, float(p[3]),
                        ord(p[4]) - ord("a") + 1.0, float(p[5]),
                        float(lut[p[6]]),
                    ]
                )
        data = np.asarray(rows)
        train, test = zscore_and_split(data[:, 0:6], data[:, 6], rng)
    else:
        raise KeyError(
            f"unknown dataset {name!r}; classification sets: "
            f"{sorted(CLASSIFICATION_TOPOLOGIES)}, regression sets: "
            f"{list(REGRESSION_SETS)}"
        )

    if name == "bank-additional":
        topo = (train.shape[1] - 1, 50, 2)
    else:
        topo = CLASSIFICATION_TOPOLOGIES[name]
    return Problem(name, "classification", topo, train, test)


def load_digits(seed: int = 0, root: str | None = None) -> Problem:
    """The 8x8 digit images for the Bayesian-CNN configuration: 1797 rows of
    64 pixels (0..16) and the label, the UCI optical-digits test set as
    scikit-learn bundles it (``classification/digits.csv.gz``). Pixels
    scaled to [0, 1]; a seeded 70/30 split (1257 / 540 rows)."""
    path = os.path.join(root or _ROOT, "classification", "digits.csv.gz")
    with gzip.open(path, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    x = data[:, :-1] / 16.0
    y = data[:, -1].astype(np.int64).astype(np.float64)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    cut = int(0.7 * len(y))
    both = np.hstack([x, y.reshape(-1, 1)])
    return Problem(
        "digits", "classification", (64, 32, 10), both[idx[:cut]], both[idx[cut:]]
    )


def load(name: str, seed: int = 0, root: str | None = None) -> Problem:
    if name in REGRESSION_SETS:
        return load_regression(name, root)
    if name == "digits":
        return load_digits(seed, root)
    return load_classification(name, seed, root)
