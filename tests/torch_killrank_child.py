"""One rank of tests/test_torch_killrank.py (not a test module): the port's
Trainer on the partitioned_bcsr dblp preset (tests/torch_parallel_ranks.py:
trainer_cfg, trainer_ds) in a gloo world of 2 CPU ranks, a checkpoint every
epoch, always fit(resume=True), so a relaunch continues from rank 0's last
save. Prints ``EPOCH <epoch> <train loss>`` as each epoch ends and ``FINAL
<last train loss> <test loss>`` at the end.

    python tests/torch_killrank_child.py RANK PORT CHECKPOINT_DIR EPOCHS

The process group times out after 10 s, so a rank whose partner died fails
instead of waiting for it."""

import datetime
import pathlib
import sys

rank, port, root, epochs = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from han_tpu_torch.train.trainer import Trainer  # noqa: E402


class EpochPrinter:
    def log(self, record):
        if "epoch" in record:
            print(f"EPOCH {record['epoch']} {record['train_loss']!r}", flush=True)


torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=10))
cfg = ranks.trainer_cfg("partitioned_bcsr", 2, epochs)
cfg.train.checkpoint_every, cfg.train.checkpoint_dir = 1, root
result = Trainer(ranks.trainer_ds(), cfg, device="cpu", logger=EpochPrinter()).fit(resume=True)
print(f"FINAL {result['epoch_train_loss'][-1]!r} {result['test_loss']!r}", flush=True)
dist.destroy_process_group()
