"""The port stands alone: no file of ``pipegoose_tpu_torch/``, not
``chip_smoke.py`` and not the rank bodies that spawned gloo processes
import by name imports ``jax`` or the JAX package ``pipegoose_tpu``, and
importing the port needs neither a card nor a built kernel."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the rank bodies that spawned gloo processes import by name
RANK_BODIES = [ROOT / "tests" / "test_torch_moe_rank_bodies.py",
               ROOT / "tests" / "test_torch_family_rank_bodies.py",
               ROOT / "tests" / "test_torch_albert_rank_bodies.py",
               ROOT / "tests" / "test_torch_diloco_rank_bodies.py"]
PORT_FILES = sorted((ROOT / "pipegoose_tpu_torch").rglob("*.py")) + RANK_BODIES + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("sweep_attn_*.py")) + sorted(
    (ROOT / "scripts").glob("sweep_fused_ce_*.py"))
FORBIDDEN = ("jax", "jaxlib", "pipegoose_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax_or_a_card():
    code = (
        "import sys\n"
        "import pipegoose_tpu_torch.serving, pipegoose_tpu_torch.ops.paged_attention\n"
        "import pipegoose_tpu_torch.serving.prefix_cache\n"
        "import pipegoose_tpu_torch.ops.fused_ce\n"
        "import pipegoose_tpu_torch.models.weights\n"
        "import pipegoose_tpu_torch.distributed, pipegoose_tpu_torch.nn.sequence_parallel\n"
        "import pipegoose_tpu_torch.parallel, pipegoose_tpu_torch.optim\n"
        "import pipegoose_tpu_torch.parallel.auto, pipegoose_tpu_torch.models._decode\n"
        "import pipegoose_tpu_torch.models.generate, pipegoose_tpu_torch.quant.weights\n"
        "import pipegoose_tpu_torch.serving.engine, pipegoose_tpu_torch.serving.kv_pool\n"
        "import pipegoose_tpu_torch.core.accumulation, pipegoose_tpu_torch.nn.data_parallel\n"
        "import pipegoose_tpu_torch.nn.tensor_parallel, pipegoose_tpu_torch.nn.parallel\n"
        "import pipegoose_tpu_torch.trainer, pipegoose_tpu_torch.trainer.recovery\n"
        "import pipegoose_tpu_torch.utils.checkpoint, pipegoose_tpu_torch.utils.procindex\n"
        "import pipegoose_tpu_torch.utils.profiler, pipegoose_tpu_torch.data\n"
        "import pipegoose_tpu_torch.distributed.compressed\n"
        "import pipegoose_tpu_torch.nn.tensor_parallel.overlap\n"
        "import pipegoose_tpu_torch.nn.pipeline_parallel\n"
        "import pipegoose_tpu_torch.nn.pipeline_parallel.partitioner\n"
        "import pipegoose_tpu_torch.nn.expert_parallel, pipegoose_tpu_torch.models.bloom_moe\n"
        "import pipegoose_tpu_torch.nn.expert_parallel.routers\n"
        "import pipegoose_tpu_torch.nn.expert_parallel.experts\n"
        "import pipegoose_tpu_torch.nn.expert_parallel.expert_parallel\n"
        "import pipegoose_tpu_torch.nn.expert_parallel.loss\n"
        "from pipegoose_tpu_torch.models import bloom_moe, BloomMoEConfig\n"
        "from pipegoose_tpu_torch.models import llama, mixtral, from_hf\n"
        "import pipegoose_tpu_torch.models.convert, pipegoose_tpu_torch.models.hf\n"
        "from pipegoose_tpu_torch.models import albert, AlbertConfig\n"
        "from pipegoose_tpu_torch.optim import diloco, DiLoCo, DiLoCoHybrid\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN,)
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
