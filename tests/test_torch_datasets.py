"""The port's dataset front door (han_tpu_torch/datasets/registry.py)
against han_tpu's: the names ``acm``/``acm3025`` (the ``.mat`` loader and
its fallback to the ACM3025-shaped fixture), ``powerlaw`` (the numpy copies
of the power-law generators), ``run()`` loading the acm preset's dataset by
name, and the names ``preset()`` accepts whose loaders are not ported,
which raise NotImplementedError."""

import pathlib

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

pytest.importorskip("jax")

from han_tpu.datasets import acm as jacm  # noqa: E402
from han_tpu.datasets.registry import load_dataset as jload  # noqa: E402
from han_tpu_torch.datasets import acm as tacm  # noqa: E402
from han_tpu_torch.datasets.registry import load_dataset as tload  # noqa: E402
from han_tpu_torch.graph import synthetic as tsyn  # noqa: E402
from han_tpu_torch.train.config import preset  # noqa: E402
from han_tpu_torch.train.trainer import run  # noqa: E402


def assert_same_dataset(got, want):
    """Every array of two HeteroDatasets equal, adjacencies included."""
    assert got.name == want.name and tuple(got.metapath_names) == tuple(want.metapath_names)
    for field in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert len(got.metapath_adjs) == len(want.metapath_adjs)
    for a, b in zip(got.metapath_adjs, want.metapath_adjs):
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a != b).nnz == 0


@pytest.mark.parametrize("name", ["acm", "acm3025"])
def test_acm_name_loads_what_han_tpu_loads(name):
    """With ACM3025.mat where han_tpu looks for it or absent (it is not in
    the repository), the port answers "acm" with the same arrays: the
    ACM3025-shaped fixture when no file is found."""
    got, want = tload(name), jload(name)
    assert_same_dataset(got, want)
    if not any(p.exists() for p in tacm._search()):
        assert got.name == "acm_synthetic" and got.n_nodes == 3025
        assert got.features.shape == (3025, 1870)


def test_powerlaw_matches_han_tpu():
    kw = dict(n_nodes=2000, edges_per_metapath=20000)
    assert_same_dataset(tload("powerlaw", **kw), jload("powerlaw", **kw))


def test_powerlaw_bipartite_is_a_copy():
    from han_tpu.graph import synthetic as jsyn

    a = tsyn.powerlaw_bipartite(300, 40, 5000, alpha=1.4, seed=9)
    b = jsyn.powerlaw_bipartite(300, 40, 5000, alpha=1.4, seed=9)
    assert a.shape == b.shape and (a != b).nnz == 0 and a.dtype == b.dtype


def tiny_mat(path: pathlib.Path, n=12, f=5, seed=0) -> None:
    """A tiny ACM3025-format .mat: one-hot labels, features, PAP and PLP
    with the identity included (the loader subtracts it), index lists."""
    rng = np.random.default_rng(seed)
    labels = np.eye(3)[rng.integers(0, 3, n)]
    adj = lambda: np.maximum((rng.random((n, n)) < 0.3), np.eye(n, dtype=bool)).astype(np.float64)
    perm = rng.permutation(n)
    sio.savemat(str(path), {
        "label": labels, "feature": rng.standard_normal((n, f)), "PAP": adj(), "PLP": adj(),
        "train_idx": perm[:4][None, :], "val_idx": perm[4:7][None, :],
        "test_idx": perm[7:][None, :]})


def test_load_acm3025_reads_a_mat_file_as_han_tpu(tmp_path):
    path = tmp_path / "ACM3025.mat"
    tiny_mat(path)
    got = tload("acm", path=path)
    assert_same_dataset(got, jacm.load_acm3025(path))
    assert got.name == "acm3025" and got.n_nodes == 12
    assert all(a.diagonal().sum() == 0 for a in got.metapath_adjs)  # identity removed
    with pytest.raises(FileNotFoundError):
        tload("acm", path=tmp_path / "absent.mat", allow_synthetic=False)


def test_run_trains_the_acm_preset_by_name():
    """run(preset("acm")) with no dataset loads it by name, as
    scripts/train_torch.py does with its default --dataset acm (csr
    attention here, to keep the test small)."""
    cfg = preset("acm")
    cfg.data.graph_format, cfg.model.impl = "csr", "csr"
    cfg.train.epochs, cfg.train.log_file = 2, ""
    result = run(cfg, device="cpu")
    losses = result["epoch_train_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all() and np.isfinite(result["test_loss"])


@pytest.mark.parametrize("name", ["dblp", "imdb", "imdb_strict", "ppi", "cora", "citeseer",
                                  "pubmed"])
def test_unported_preset_names_raise_not_implemented(name):
    """Every other name preset() accepts names its missing loader."""
    preset(name)  # the name is a preset
    with pytest.raises(NotImplementedError, match=r"han_tpu/datasets/\w+\.py:load_\w+"):
        tload(name)
    with pytest.raises(KeyError):
        tload("no_such_dataset")


def test_acm_synthetic_is_the_fixture():
    assert_same_dataset(tload("acm_synthetic"), jload("acm_synthetic"))
