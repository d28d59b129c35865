"""Port parity for the fault drill, on the CPU.

- The JAX package's ``TestFaultDrill`` (``tests/unit/test_resilience.py``)
  runs on the port's fault sites and drill, here with ``--device cpu``:
  the torn-save training drill (``mid_save`` and
  ``post_save_pre_latest``: a worker crashed at the site, a second one
  resumes from the newest valid tag and finishes), the documented site
  set, and (slow, as in JAX) the hard-crash plus SIGTERM serve drill; so
  does the slow ``TestServeDrillFlightDump``
  (``tests/unit/test_telemetry.py``).
- One serve site, ``mid_commit``, crashes a worker subprocess hard and
  recovers on a fresh engine from the journal, token-identical to the
  uninterrupted run, with the pool whole and a flight dump written.
- The sites not ported refuse before any worker runs, naming their queue
  items: ``collective`` (A8; so the default ``--mode train``, which
  includes it, and ``all``) and ``train_goodput`` (A7.6); without a card
  the default ``--device`` raises.
"""

import json
import os
import subprocess
import sys

import pytest

from deepspeed_tpu_torch.resilience import faultdrill
from torch_port_cases import ROOT, port_cases


@pytest.fixture(autouse=True)
def _drill_on_the_cpu(monkeypatch):
    """The drill's workers build their engines on the CPU (the drill's
    own default is the card), each on one intra-op thread (its ops are
    tiny, and the test workers' thread pools would contend)."""
    monkeypatch.setitem(faultdrill._DEVICE, "name", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


(TestFaultDrill,) = port_cases(
    "tests/unit/test_resilience.py", ("TestFaultDrill",), ("resilience",),
    subs=(('["--mode", "serve", "--sites", "mid_commit,sigterm",\n'
           '                   "--workdir", str(tmp_path)]',
           '["--mode", "serve", "--sites", "mid_commit,sigterm",\n'
           '                   "--workdir", str(tmp_path), "--device", '
           '"cpu"]'),
          ('["--sites", "mid_save,post_save_pre_latest",\n'
           '                   "--workdir", str(tmp_path)]',
           '["--sites", "mid_save,post_save_pre_latest",\n'
           '                   "--workdir", str(tmp_path), "--device", '
           '"cpu"]')))
(TestServeDrillFlightDump,) = port_cases(
    "tests/unit/test_telemetry.py", ("TestServeDrillFlightDump",),
    ("resilience",))


def test_serve_drill_site_recovers_on_the_cpu(tmp_path, capsys):
    """The drill's main path for one site: the oracle, a hard
    ``os._exit`` at ``mid_commit`` after three commits, recovery from the
    write-ahead journal on a fresh engine."""
    assert faultdrill.main(["--mode", "serve", "--sites", "mid_commit",
                            "--workdir", str(tmp_path), "--device",
                            "cpu"]) == 0
    out = capsys.readouterr().out
    res = json.loads(out[out.index("{"):])
    assert res["ok"] is True
    (r,) = res["results"]
    assert r["site"] == "mid_commit" and r["fault_fired"]
    assert r["crash_rc"] not in (0, 99)
    assert r["flight_dump"] is True
    assert r["token_parity"] is True and r["pool_recovered"] is True
    assert r["replayed_sequences"] == faultdrill.SERVE_DRILL_REQS
    assert os.path.exists(tmp_path / "oracle.json")
    assert os.path.exists(tmp_path / "serve_mid_commit" / "replay.jsonl")


@pytest.mark.parametrize("argv", [[], ["--mode", "train"],
                                  ["--mode", "train_goodput"],
                                  ["--mode", "all"],
                                  ["--mode", "serve", "--sites",
                                   "mid_commit,collective"]])
def test_training_drills_name_their_items(argv, tmp_path):
    """The default training sites and ``all`` include ``collective``
    (A8); ``train_goodput`` is A7.6. Refused before any worker runs."""
    item = "A7.6" if "train_goodput" in argv else "A8"
    with pytest.raises(NotImplementedError, match=item):
        faultdrill.main([*argv, "--device", "cpu", "--workdir",
                         str(tmp_path)])
    assert not os.listdir(tmp_path)          # refused before any run
    with pytest.raises(NotImplementedError, match="A8"):
        faultdrill.drill_site("collective", str(tmp_path))
    with pytest.raises(NotImplementedError, match="A7.6"):
        faultdrill.drill_train_goodput(str(tmp_path))
    assert not os.listdir(tmp_path)


def test_device_defaults_to_the_card(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        faultdrill.main(["--mode", "serve", "--workdir", str(tmp_path)])
    with pytest.raises(SystemExit):
        faultdrill.main(["--mode", "serve", "--sites", "nowhere",
                         "--device", "cpu"])


def test_module_entry_point_refuses_the_training_default():
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.resilience.faultdrill",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and "A8" in out.stderr
