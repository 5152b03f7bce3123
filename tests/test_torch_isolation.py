"""The port imports neither JAX nor the JAX package, not even indirectly."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_port_imports_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.core.engine" in mods and len(mods) >= 45
    for m in ("models.recsys", "configs.two_tower_retrieval",
              "kernels.topk_score", "kernels.embedding_bag",
              "examples.speculative_retrieval", "models.common",
              "models.attention", "models.moe", "models.transformer",
              "kernels.flash_attention", "configs.lm_common",
              "configs.gemma2_2b", "configs.starcoder2_3b",
              "data.graph_synth", "models.gnn.graph", "models.gnn.gat",
              "models.gnn.padded",
              "kernels.neigh_agg", "configs.gnn_common", "configs.gat_cora",
              "core.sketches", "examples.quickstart", "examples.serve_kg",
              "examples.serve_soak", "core.distributed", "launch.mesh",
              "train.tree", "train.optimizer", "train.compression",
              "train.loop", "train.checkpoint", "train.fault_tolerance",
              "examples.train_retrieval", "configs.kg_specqp",
              "launch.train", "examples.train_lm", "models.gnn.e3",
              "models.gnn.egnn", "models.gnn.nequip", "models.gnn.mace",
              "configs.egnn", "configs.nequip", "configs.mace",
              "sharding", "configs.base", "launch.analysis",
              "launch.dryrun"):
        assert f"repro_torch.{m}" in mods, m
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["bad = sorted(m for m in sys.modules if m == 'jax' or "
           "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))",
           "assert not bad, bad", "print('ok', len(sys.modules))"])
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax_or_repro_import():
    for p in PKG.rglob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (p, line)


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert s.split()[1].split(".")[0] not in ("jax", "repro"), line


def test_sharding_and_dry_run_start_nothing_when_imported():
    """Importing the sharding and dry-run modules starts no process group,
    builds and loads no kernel, and leaves no rules installed; importing
    the kernels registers the attention's custom ops and their FLOP
    formulas, and builds nothing either."""
    code = "\n".join([
        "import torch, torch.distributed as dist",
        "from repro_torch import sharding",
        "from repro_torch.configs import base",
        "from repro_torch.launch import analysis, dryrun",
        "from repro_torch.kernels import _build",
        "from torch.utils.flop_counter import flop_registry",
        "assert not dist.is_initialized()",
        "assert not _build._libs and not _build.build_log",
        "assert not sharding.active()",
        "from repro_torch.kernels import ops",
        "assert not _build._libs and not dist.is_initialized()",
        "op = torch.ops.repro_torch.flash_attention",
        "assert op in flop_registry",
        "assert torch.ops.repro_torch.flash_attention_backward in "
        "flop_registry",
        "print('ok')"])
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
