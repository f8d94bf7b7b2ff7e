"""The slice as a whole: han_tpu_torch's training step on the dblp preset
(BCSR graphs, flash attention) against han_tpu's Trainer.train_step (flash
in interpret mode), plus the port's fit()/run() and entry script."""

import json
import runpy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from han_tpu.train import trainer as jtrainer  # noqa: E402
from han_tpu.train.config import preset as jpreset  # noqa: E402
from han_tpu_torch.nn.convert import params_from_flax  # noqa: E402
from han_tpu_torch.train import trainer as ttrainer  # noqa: E402
from han_tpu_torch.train.config import preset as tpreset  # noqa: E402


def dblp_cfg(preset, **train):
    cfg = preset("dblp")
    cfg.data.tile_bm = cfg.data.tile_bn = 128
    cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def test_train_steps_match_jax(tiny_ds, tmp_path):
    """Five Adam steps from the same flax initial weights, dropout off:
    train loss and accuracy agree to rtol 1e-4. (Adam divides by √v, which
    amplifies float differences of small gradients step by step, so the
    tolerance is wider than one forward's.)"""
    jcfg = dblp_cfg(jpreset, checkpoint_dir=str(tmp_path / "ckpt"))
    jt = jtrainer.Trainer(tiny_ds, jcfg, logger=jtrainer.MetricLogger(echo=False))
    params = jt.init_params()
    opt_state = jt.tx.init(params)
    rng = jax.random.PRNGKey(0)

    tt = ttrainer.Trainer(tiny_ds, dblp_cfg(tpreset), device="cpu",
                          logger=ttrainer.MetricLogger(echo=False))
    tt.model.load_state_dict(params_from_flax(params))
    for step in range(5):
        params, opt_state, rng, jloss, jacc, jalphas = jt.train_step(params, opt_state, rng)
        tloss, tacc, talphas = tt.train_step()
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tacc), float(jacc), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(talphas.numpy(), np.asarray(jalphas), atol=1e-4)
    final = params_from_flax(params)
    for k, v in tt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=1e-4, err_msg=k)


def test_early_stop_policy_matches_reference():
    """ex_acm3025.py:225-240: keep as best iff acc AND loss both improve;
    patience counts epochs where NEITHER improves."""
    es = ttrainer.EarlyStopState()
    keep, bad = es.update(1.0, 0.5)
    assert keep and not bad and es.bad_epochs == 0
    keep, bad = es.update(1.2, 0.6)
    assert not keep and not bad and es.bad_epochs == 0
    assert es.best_val_acc == 0.6 and es.best_val_loss == 1.0
    keep, bad = es.update(1.5, 0.4)
    assert not keep and bad and es.bad_epochs == 1
    keep, _ = es.update(0.9, 0.7)
    assert keep and es.bad_epochs == 0


def test_fit_with_dropout_logs_and_restores_best(tiny_ds, tmp_path):
    """The dblp preset with its 0.6 dropouts through fit(): finite losses,
    a jsonl line per epoch, early stop after `patience` bad epochs, and the
    restored best parameters reproduce the logged best validation loss."""
    cfg = tpreset("dblp_synthetic")
    cfg.data.tile_bm = cfg.data.tile_bn = 64
    cfg.train.epochs, cfg.train.patience = 40, 3
    cfg.train.lr = 0.05  # overshoots, so the early stop triggers
    cfg.train.log_file = str(tmp_path / "metrics.jsonl")
    t = ttrainer.Trainer(tiny_ds, cfg, device="cpu",
                         logger=ttrainer.MetricLogger(cfg.train.log_file, echo=False))
    result = t.fit()
    lines = [json.loads(line) for line in open(cfg.train.log_file)]
    epochs = [r for r in lines if "epoch" in r]
    assert len(epochs) == len(result["epoch_train_loss"]) <= cfg.train.epochs
    assert np.isfinite(result["epoch_train_loss"]).all() and np.isfinite(result["test_loss"])
    np.testing.assert_allclose(sum(epochs[0]["semantic_alphas"]), 1.0, atol=2e-3)
    assert len(epochs) < cfg.train.epochs and "early_stop" in lines[len(epochs)]
    best = result["best_epoch"]
    assert 0 <= best <= len(epochs) - 1 - cfg.train.patience
    vl, _, _, _ = t.eval_step(t.masks["val"])
    np.testing.assert_allclose(float(vl), epochs[best]["val_loss"], rtol=1e-5)


def test_entry_script_runs(capsys, tmp_path, monkeypatch):
    """scripts/train_torch.py's CLI: preset + overrides → run()."""
    main = runpy.run_path("scripts/train_torch.py", run_name="not_main")["main"]
    result = main(["--device", "cpu", "--dataset", "acm_synthetic", "--set",
                   "data.graph_format=csr", "--set", "model.impl=csr", "--set", "train.epochs=2"])
    assert len(result["epoch_train_loss"]) == 2
    assert 0.0 <= result["test_acc"] <= 1.0 + 1e-6  # mean-normalized mask
    assert "test_acc" in capsys.readouterr().out
    # the raw DBLP files are not in the repository: no fallback
    from han_tpu_torch.datasets import base

    monkeypatch.setattr(base, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(base, "REFERENCE_DATA", tmp_path)
    with pytest.raises(FileNotFoundError, match="author_label"):
        ttrainer.run(tpreset("dblp"), device="cpu")


def test_no_cpu_fallback_without_a_card(monkeypatch, tiny_ds):
    """With CUDA unavailable, Trainer, SampledTrainer, run(), make_mesh and
    scripts/train_torch.py given no device raise, naming device="cpu";
    they never train on the CPU unasked. Asked for the CPU, they run."""
    from han_tpu_torch.parallel.mesh import make_mesh
    from han_tpu_torch.train.sampled import SampledTrainer

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    cfg = tpreset("acm_synthetic")
    cfg.train.epochs = 1
    main = runpy.run_path("scripts/train_torch.py", run_name="not_main")["main"]
    for call in (lambda: ttrainer.Trainer(tiny_ds, cfg),
                 lambda: SampledTrainer(tiny_ds, cfg, batch_size=8, fanout=3),
                 lambda: ttrainer.run(cfg, tiny_ds),
                 lambda: make_mesh(graph=1),
                 lambda: main(["--dataset", "acm_synthetic"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert make_mesh(graph=1, device="cpu").device.type == "cpu"
    result = main(["--device", "cpu", "--dataset", "acm_synthetic", "--set", "train.epochs=1"])
    assert len(result["epoch_train_loss"]) == 1
