"""The port stands alone: importing every laff_tpu_torch module (and
chip_smoke.py) loads neither JAX nor the JAX package nor transformers (the
card's machine may have none, or a version without the Flax classes: the
BERT tower and its tokenizer are the port's own), and chip_smoke.py
refuses to run without a card or without the package beside it."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import laff_tpu_torch
names = [m.name for m in pkgutil.walk_packages(laff_tpu_torch.__path__, "laff_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "flax", "laff_tpu", "transformers")
             or k.startswith(("jax.", "jaxlib.", "flax.", "laff_tpu.", "transformers.")))
covered = all(n in names for n in {required!r})
print(len(names), "modules;", "forbidden:", bad, covered)
"""

# modules the walk must reach: the native featurizer, the FrameLAFF configs,
# the checkpoint interchange, the registry, the configs that reference
# checkpoints name, the re-rankers, the TRECVID harness with its CLI, the
# int8 gallery, the host data CLIs, the live CLIP towers and End2EndClip,
# the BERT tower, the retrieval server and its full-width BERT config, the
# seed sweep, the orchestrator and its two CLIs, the mesh and the sharded
# similarity engine, the reproduction, two-stage AVS and multi-process
# entry points
REQUIRED = ("laff_tpu_torch.native", "laff_tpu_torch.eval.rerank",
            "laff_tpu_torch.ops.quantized", "laff_tpu_torch.data.check",
            "laff_tpu_torch.cli.build_vocab", "laff_tpu_torch.cli.txt2bin",
            "laff_tpu_torch.cli.check_data",
            "laff_tpu_torch.eval.trecvid", "laff_tpu_torch.eval.trecvid.infap",
            "laff_tpu_torch.eval.trecvid.trec_eval", "laff_tpu_torch.eval.trecvid.txt2xml",
            "laff_tpu_torch.cli.avs_eval",
            "laff_tpu_torch.configs.frame_rehearsal",
            "laff_tpu_torch.configs.FrameLaff_NoFrameFc_StrongCLIP_adjust",
            "laff_tpu_torch.engine.torch_import", "laff_tpu_torch.engine.torch_export",
            "laff_tpu_torch.models.registry", "laff_tpu_torch.configs.tiny",
            "laff_tpu_torch.configs.tiny_tied", "laff_tpu_torch.configs.concat_rehearsal",
            "laff_tpu_torch.models.clip", "laff_tpu_torch.models.clip.tokenizer",
            "laff_tpu_torch.models.clip.towers", "laff_tpu_torch.models.clip.resnet",
            "laff_tpu_torch.models.clip.load", "laff_tpu_torch.models.end2end_clip",
            "laff_tpu_torch.data.frames", "laff_tpu_torch.data.end2end",
            "laff_tpu_torch.engine.end2end", "laff_tpu_torch.configs.end2end_clip",
            "laff_tpu_torch.configs.e2e_tiny", "laff_tpu_torch.models.bert",
            "laff_tpu_torch.engine.service", "laff_tpu_torch.cli.do_server",
            "laff_tpu_torch.configs.bert_rehearsal", "laff_tpu_torch.engine.sweep",
            "laff_tpu_torch.engine.orchestrate", "laff_tpu_torch.cli.retrieval_task",
            "laff_tpu_torch.cli.all_run", "laff_tpu_torch.parallel",
            "laff_tpu_torch.parallel.mesh", "laff_tpu_torch.parallel.sim_engine",
            "laff_tpu_torch.cli.reproduce_mvtest3k",
            "laff_tpu_torch.cli.do_pretrain_gcc_train_avs",
            "laff_tpu_torch.cli.multihost_smoke")


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, on any host
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=240)


def test_port_imports_no_jax_and_no_laff_tpu():
    proc = _run([sys.executable, "-c", _IMPORT_ALL.format(root=ROOT, required=REQUIRED)],
                ROOT)
    assert proc.returncode == 0, proc.stderr
    count, _, rest = proc.stdout.strip().partition(" modules;")
    assert int(count) >= 89  # every module was walked, the three new CLIs' included
    assert rest.strip() == "forbidden: [] True", proc.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    proc = _run([sys.executable, "chip_smoke.py"], cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    reason = "not beside chip_smoke.py" if alone else "is_available() is false"
    assert reason in proc.stderr
