"""The port's surface holds the JAX package's, name by name: every public
top-level class, function and constant of each ``goliath_tpu/**/*.py`` is
defined in the counterpart file of ``goliath_torch/`` (the same relative
path), but for the allowlist below, each entry with its reason. The JAX
package's entry point ``examples/render_example.py`` has its counterpart in
``goliath_torch/examples/``.

Read from the sources with ``ast``; this file imports neither package. A
name counts as defined where a ``def``, a ``class`` or an assignment at the
top level of the file binds it (an import does not).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "goliath_tpu", ROOT / "goliath_torch"

# The TPU kernels' modules map onto the CUDA kernels' wrappers: each Pallas
# function onto the wrapper of the kernel that replaces it
# (ops/gsplat_cuda.py REPLACES), the two Pallas switches onto nothing.
RENAMED_FILES = {"ops/gsplat_pallas.py": "ops/gsplat_cuda.py",
                 "ops/rasterizer_pallas.py": "ops/rasterizer_cuda.py"}
RENAMED = {
    ("ops/gsplat_pallas.py", "cumsum1d_pl"): "cumsum1d",
    ("ops/gsplat_pallas.py", "cumsum_cols_pl"): "cumsum_cols",
    ("ops/gsplat_pallas.py", "cumsum_rows_pl"): "cumsum_rows",
    ("ops/gsplat_pallas.py", "rasterize_tiled_pallas_fwd"): "compositor_fwd",
    ("ops/gsplat_pallas.py", "pair_grads_pallas"): "pair_grads",
    ("ops/gsplat_pallas.py", "rasterize_tiled_pl"): "rasterize_tiled",
    # the fold is rasterize_tiled's image axis (n_imgs)
    ("ops/gsplat_pallas.py", "rasterize_tiled_pl_fold"): "rasterize_tiled",
    ("ops/rasterizer_pallas.py", "rasterize_zbuffer_pallas"): "zbuffer",
    # the port scrubs the gradients in place (a trailing underscore, as
    # torch names in-place operations)
    ("optim.py", "scrub_nonfinite"): "scrub_nonfinite_",
}
# names the port defines in another of its modules (and imports where the
# JAX package defines them, where it uses them there)
ELSEWHERE = {
    ("ops/gsplat.py", "ALPHA_CLIP"): "ops/gsplat_cuda.py",
    ("ops/gsplat.py", "ALPHA_MIN"): "ops/gsplat_cuda.py",
    ("ops/gsplat.py", "rasterize_tiled"): "ops/gsplat_cuda.py",
    ("ops/rasterizer.py", "BIG_DEPTH"): "ops/rasterizer_cuda.py",
    ("train.py", "load_checkpoint"): "convert.py",
}
NO_COUNTERPART = {
    ("__init__.py", "enable_compilation_cache"):
        "JAX's persistent compilation cache; the kernels' build cache is "
        "build/ (torch.utils.cpp_extension.load)",
    ("ops/backend.py", "force_backend"):
        "the port dispatches on each tensor's device "
        "(goliath_torch/ops/backend.py)",
    ("ops/mvp.py", "CKPT_CHUNK"):
        "the JAX march's remat switch of a chunk (jax.checkpoint)",
    ("ops/mvp.py", "CKPT_GROUP"):
        "the JAX march's remat switch of a tile group (jax.checkpoint)",
    ("ops/gsplat_pallas.py", "INTERPRET"):
        "Pallas interpret mode; a CUDA kernel has none (on the CPU a "
        "wrapper runs its kernel's plain version)",
    ("ops/gsplat_pallas.py", "PREFIX_PRECISION"):
        "the TPU matmul precision of the Pallas scans' prefix products",
}
# module loggers are per module in both packages and no part of the surface
IGNORED = {"logger"}


def defined(path: Path):
    """The public names a file binds at its top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return {n for n in names if not n.startswith("_")}


JAX_FILES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def counterpart(rel: str) -> Path:
    return PORT / RENAMED_FILES.get(rel, rel)


def missing_names(rel: str):
    """The names of the JAX file ``rel`` that the port lacks, after the
    allowlist, and each allowlist entry that no longer applies."""
    port = defined(counterpart(rel))
    missing, stale = [], []
    for name in sorted(defined(JAX / rel) - IGNORED):
        key = (rel, name)
        if key in NO_COUNTERPART:
            continue
        if key in RENAMED:
            if RENAMED[key] not in port:
                missing.append(f"{name} (as {RENAMED[key]})")
        elif key in ELSEWHERE:
            if name not in defined(PORT / ELSEWHERE[key]):
                missing.append(f"{name} (in {ELSEWHERE[key]})")
        elif name not in port:
            missing.append(name)
    return missing


@pytest.mark.parametrize("rel", JAX_FILES)
def test_each_jax_module_has_its_names_in_the_port(rel):
    assert counterpart(rel).is_file(), f"no counterpart of goliath_tpu/{rel}"
    missing = missing_names(rel)
    assert not missing, f"goliath_tpu/{rel}: not in the port: {missing}"


def test_the_allowlist_is_exact():
    """Every allowlist entry names a definition of its JAX file that the
    port does not define under the same name in the counterpart file."""
    for rel, name in [*RENAMED, *ELSEWHERE, *NO_COUNTERPART]:
        assert name in defined(JAX / rel), (rel, name)
        assert name not in defined(counterpart(rel)), (rel, name)
    assert len(JAX_FILES) > 60


def test_the_render_example_has_its_counterpart():
    jax_example = ROOT / "examples" / "render_example.py"
    port_example = PORT / "examples" / "render_example.py"
    assert port_example.is_file()
    assert {"image_grid", "main"} <= defined(jax_example) <= defined(
        port_example)
    assert "render" in defined(port_example)
