"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level names, so the port, ``laff_tpu_torch``, is not the JAX
package ``laff_tpu``), and the reference loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

PRELUDE = f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
TOPS = "lambda: sorted({m.split('.')[0] for m in sys.modules})"


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_modules_load_no_jax():
    got = _run(f"""
import portbench.run, portbench.control, portbench.drivers.train, portbench.drivers.val
from portbench import harness
for m in harness.benchmark()["per_layer"]:
    harness.load_module("metrics", m["name"])
print(json.dumps({{"tops": ({TOPS})()}}))
""")
    assert not {"jax", "jaxlib", "flax", "laff_tpu"} & set(got["tops"])


def test_a_run_loads_no_jax():
    got = _run(f"""
import time, logging, torch
logging.disable(logging.INFO)
import conftest
from portbench import harness, run
class MP:
    def setattr(self, obj, name, value): setattr(obj, name, value)
c = conftest.tiny_cell("val")
conftest.shrink_port(MP(), c["config"])
args = run.parse(["--workload", c["workload"]["name"], "--seed", "3", "--seconds", "0.3"])
out = run.run_cell(args, device=torch.device("cpu"), t_start=time.perf_counter(), cell=c)
print(json.dumps({{"tops": ({TOPS})(), "found": harness.forbidden_modules(),
                  "correct": out["result"]["correct"]}}))
""")
    assert got["found"] == [] and "laff_tpu_torch" in got["tops"] and got["correct"]


def test_reference_loads_nothing_of_the_port(tmp_path):
    got = _run(f"""
import torch, conftest
from portbench import program, world
from portbench.control import shapes_of
from portbench.reference.model import ReferenceModel
from portbench.reference.train import train_steps
from portbench.weights import make_weights
cfg = conftest.tiny_config()
world.build_world({str(tmp_path)!r}, "tiny", 12, 4, conftest.caption_words(),
                  n_vocab=conftest.TINY_VOCAB, seed=1)
text, video = program.reference_inputs(cfg, {str(tmp_path)!r}, "tiny")
w0 = make_weights(shapes_of(cfg, text), 2, torch.device("cpu"))
caps = text.ids[:8]
batch = (program.to_device(text.featurize(caps), "cpu"),
         program.to_device(video.featurize([c.split("#")[0] for c in caps]), "cpu"))
train_steps(cfg, w0, [batch], gen_seed=5)
ReferenceModel(cfg, w0).encode_vis(batch[1])
print(json.dumps({{"tops": ({TOPS})()}}))
""")
    assert not {"laff_tpu_torch", "laff_tpu", "jax"} & set(got["tops"])
