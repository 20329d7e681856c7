"""The port's preemption-tolerant batch training IT: the mirror of
``tests/test_batch_resume_it.py`` on ``python -m oryx_tpu_torch.cli batch``.

``kill -9`` a real port ``cli batch`` process mid-ALS-training; the
restarted process must resume the generation from the newest checkpoint —
redoing at most what one interval plus the time to the kill cost, proven by
the checkpoint metadata's iteration counters — and publish a model that
passes the planted-structure AUC bar of ``tests/test_als_quality.py``
(> 0.75).

Choreography (three incarnations of the port's ``cli batch`` over a
``file:`` broker, on the CPU: ``oryx.batch.streaming.config.platform =
"cpu"``):

  A. seed generation: 500 planted ratings → MODEL #1 published, input
     offsets committed, clean SIGTERM;
  B. feed the full planted set, restart batch, wait for the generation's
     FIRST checkpoint file to land, then SIGKILL mid-training;
  C. restart again: same uncommitted offsets → same input slice → same
     data fingerprint → resume; wait for MODEL #2.

One difference from the reference's configuration: every checkpoint save
sleeps ``SAVE_LATENCY_MS`` first (``oryx.faults.spec`` ``ckpt.save=
latency:MS``). Each save joins the previous one, so this paces the loop
to at least that much per interval: the port's CPU trainer could otherwise
finish between the first checkpoint and the kill. It changes no factor.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from oryx_tpu_torch.api.keymessage import KeyMessage
from oryx_tpu_torch.common import checkpoint as ck
from oryx_tpu_torch.common import config as cfg
from oryx_tpu_torch.ml import mlupdate
from oryx_tpu_torch.models.als.update import ALSUpdate
from oryx_tpu_torch.pmml import pmmlutils
from oryx_tpu_torch.store.datastore import ModelStore
from oryx_tpu_torch.transport import topic as tp
from test_als_quality import _synthetic_movielens

# six xdist workers share the CPU with wall-clock gates elsewhere in the suite
torch.set_num_threads(1)

ITERATIONS = 16
CKPT_INTERVAL = 2
SAVE_LATENCY_MS = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conf(tmp_path) -> Path:
    conf = tmp_path / "app.conf"
    conf.write_text(f"""
oryx {{
  id = "ckpt-it"
  input-topic.broker = "file:{tmp_path}/topics"
  update-topic.broker = "file:{tmp_path}/topics"
  batch {{
    streaming.generation-interval-sec = 1
    streaming.config.platform = "cpu"
    update-class = "oryx_tpu_torch.models.als.update.ALSUpdate"
    storage {{
      data-dir = "{tmp_path}/data/"
      model-dir = "{tmp_path}/model/"
    }}
    checkpoint {{
      enabled = true
      dir = "{tmp_path}/ckpt/"
      interval-iterations = {CKPT_INTERVAL}
      keep = 3
    }}
  }}
  faults {{
    enabled = true
    spec = "ckpt.save=latency:{SAVE_LATENCY_MS}"
  }}
  als {{
    iterations = {ITERATIONS}
    no-known-items = true
    hyperparams {{ features = 20, lambda = 0.01 }}
  }}
  ml.eval.test-fraction = 0.1
}}
""")
    return conf


def _spawn_batch(conf: Path, log: Path) -> subprocess.Popen:
    # the child's torch gets one thread: six xdist workers share the CPU,
    # and timing-sensitive tests run beside this one
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    with open(log, "ab") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "oryx_tpu_torch.cli", "batch", "--conf",
             str(conf)],
            env=env, stdout=out, stderr=subprocess.STDOUT, cwd=REPO,
        )


def _model_keys(broker) -> list:
    return [km.key for km in broker.read("OryxUpdate", 0, 500_000)
            if km.key == "MODEL"]


def _wait(predicate, deadline_sec: float, what: str, log: Path,
          poll: float = 0.1):
    deadline = time.monotonic() + deadline_sec
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(poll)
    pytest.fail(f"timed out waiting for {what}; log tail:\n"
                + log.read_text(errors="replace")[-3000:])


def test_batch_kill9_resumes_from_checkpoint_and_converges(tmp_path):
    lines = _synthetic_movielens()
    seed_lines, gen2_lines = lines[:500], lines[500:]
    conf = _conf(tmp_path)
    log = tmp_path / "batch.log"
    broker = tp.get_broker(f"file:{tmp_path}/topics")
    broker.create_topic("OryxInput")
    broker.create_topic("OryxUpdate")
    offsets_file = (tmp_path / "topics" / ".offsets"
                    / "OryxGroup-batch-ckpt-it__OryxInput.json")
    ckpt_dir = tmp_path / "ckpt"
    procs = []
    try:
        # --- A: seed generation, committed cleanly -----------------------
        # a first-boot layer subscribes at "latest": pre-commit offset 0 for
        # its group so the seed lines are covered whenever the pump starts
        broker.set_offset("OryxGroup-batch-ckpt-it", "OryxInput", 0)
        p = _spawn_batch(conf, log)
        procs.append(p)
        for ln in seed_lines:
            broker.append("OryxInput", None, ln)
        _wait(lambda: len(_model_keys(broker)) >= 1, 120, "MODEL #1", log)
        _wait(lambda: offsets_file.exists()
              and json.loads(offsets_file.read_text())["offset"]
              == len(seed_lines), 30, "gen-1 offset commit", log)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) is not None
        pre_existing = {f.name for f in ckpt_dir.glob("ckpt-*.oryx")}

        # --- B: feed generation 2, restart, kill -9 mid-training ---------
        for ln in gen2_lines:
            broker.append("OryxInput", None, ln)
        p = _spawn_batch(conf, log)
        procs.append(p)

        def first_new_ckpt():
            for f in ckpt_dir.glob("ckpt-*.oryx"):
                if f.name not in pre_existing:
                    return f.name
            return None

        seen_name = _wait(first_new_ckpt, 180,
                          "generation-2's first checkpoint", log, poll=0.02)
        fp_seen, step_seen = seen_name[len("ckpt-"):-len(".oryx")].split("-")
        step_seen = int(step_seen)
        assert 0 < step_seen < ITERATIONS
        p.send_signal(signal.SIGKILL)
        assert p.wait(timeout=10) is not None
        # the kill preempted the offset commit: gen 2 is still uncommitted
        assert json.loads(offsets_file.read_text())["offset"] == len(seed_lines)

        # --- C: restart; resume; MODEL #2 --------------------------------
        p = _spawn_batch(conf, log)
        procs.append(p)
        _wait(lambda: len(_model_keys(broker)) >= 2, 240, "MODEL #2", log)
        _wait(lambda: json.loads(offsets_file.read_text())["offset"]
              == len(lines), 30, "gen-2 offset commit", log)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) is not None

        # exactly the two generations published
        assert len(_model_keys(broker)) == 2

        # --- iteration accounting: bounded redo, via the ckpt metadata ---
        store = ck.CheckpointStore(ckpt_dir)
        final = store.load_latest(fp_seen)
        assert final is not None, "no valid checkpoint for the generation"
        assert final.meta["completed"] == ITERATIONS
        resumed_from = final.meta["resumed_from"]
        assert resumed_from >= step_seen > 0, (resumed_from, step_seen)

        # --- convergence gate: the published model passes the quality bar
        model_dir = ModelStore(str(tmp_path / "model")).latest()
        pmml = pmmlutils.read(model_dir / mlupdate.MODEL_FILE_NAME)
        config = cfg.Config.parse_file(str(conf)).overlay_on(cfg.get_default())
        update = ALSUpdate(config, device="cpu")
        # the layer held out the time-ordered last 10% of generation 2's
        # NEW data; evaluate on that exact slice
        train_new, test = update.split_new_data_to_train_test(
            [KeyMessage(None, ln) for ln in gen2_lines]
        )
        train = train_new + [KeyMessage(None, ln) for ln in seed_lines]
        auc = update.evaluate(None, pmml, model_dir, test, train)
        assert auc > 0.75, f"resumed model under the quality bar: AUC={auc}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
