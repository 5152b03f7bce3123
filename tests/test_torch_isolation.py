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
              "examples.train_retrieval", "configs.kg_specqp"):
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
