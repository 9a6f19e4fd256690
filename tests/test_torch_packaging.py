"""The port stands alone: no module of it (nor ``chip_smoke.py``) imports
JAX, Flax or the JAX package; its configuration mirrors the reference's
field for field; its directory mirrors the reference's names."""

import ast
import dataclasses
import importlib
import pathlib

import pytest

import distributed_llm_inference_tpu.config as jcfg
import distributed_llm_inference_tpu_torch.config as tcfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "distributed_llm_inference_tpu_torch"
REFERENCE = ROOT / "distributed_llm_inference_tpu"
FORBIDDEN = ("jax", "flax", "distributed_llm_inference_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_covers_the_sharded_serving_modules():
    walked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {f"parallel/{m}.py" for m in (
        "__init__", "comm", "mesh", "tp", "pipeline", "ring")} <= walked


def test_every_module_imports_without_a_gpu_or_compiler():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        importlib.import_module(name)


@pytest.mark.parametrize("cls", [
    "RopeScaling", "LatentConfig", "ModelConfig", "CacheConfig", "EngineConfig",
    "ServingConfig", "PrefixConfig", "MeshConfig",
])
def test_config_fields_and_defaults_match_the_reference(cls):
    def spec(c):
        return [
            (f.name, f.default, f.hash, f.compare) for f in dataclasses.fields(c)
        ]

    mine, theirs = getattr(tcfg, cls), getattr(jcfg, cls)
    got, want = spec(mine), spec(theirs)
    # Nested config defaults compare by value across the two packages.
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g[2:] == w[2:], g[0]
        assert g[1] == w[1] or (
            dataclasses.is_dataclass(g[1])
            and dataclasses.asdict(g[1]) == dataclasses.asdict(w[1])
        ), g[0]
    assert mine.__dataclass_params__.frozen


def test_from_hf_config_matches_the_reference():
    hf = dict(
        model_type="llama", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=500000.0,
        max_position_embeddings=8192,
        rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    )
    for d in (hf, dict(hf, model_type="qwen2", sliding_window=4096),
              dict(hf, kv_lora_rank=512, qk_rope_head_dim=64)):
        got = dataclasses.asdict(tcfg.ModelConfig.from_hf_config(d))
        want = dataclasses.asdict(jcfg.ModelConfig.from_hf_config(d))
        assert got == want
    cfg = tcfg.ModelConfig.from_hf_config(hf)
    assert cfg.q_per_kv == 4 and cfg.head_dim == 128 and not cfg.use_latent


def test_port_mirrors_the_reference_file_names():
    for path in PORT.rglob("*.py"):
        rel = path.relative_to(PORT)
        if rel.name in ("_build.py", "device.py", "graphs.py", "comm.py"):
            continue  # no JAX counterpart
        assert (REFERENCE / rel).exists(), f"{rel} has no counterpart"
    from distributed_llm_inference_tpu_torch.ops import _build

    sources = sorted(p.name for p in (PORT / "csrc").glob("*.cu"))
    assert sources == [
        "flash_attention.cu", "int4_matmul.cu", "latent_attention.cu",
        "paged_attention.cu", "quant_attention.cu", "ragged_attention.cu",
        "sink_attention.cu"]
    assert sources == sorted(f"{n}.cu" for n in _build.KERNEL_SOURCES)


def test_package_data_ships_every_cuda_source():
    """``pyproject.toml``'s package data for the port covers every file
    under ``csrc/`` (the kernels are built from them at first use)."""
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["distributed_llm_inference_tpu_torch"]
    shipped = {p for pat in patterns for p in PORT.glob(pat)}
    every = {p for p in (PORT / "csrc").rglob("*") if p.is_file()}
    assert every and shipped == every


def test_chip_smoke_refuses_to_run_without_a_gpu():
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
