"""Twins of ``tests/test_sharding_rules.py`` on the port: the logical-axis
-> mesh-axis resolver (pure; no devices — the meshes are abstract).  For
each case the port's spec tuple equals ``tuple(...)`` of the reference's
``PartitionSpec`` over the reference's ``AbstractMesh``."""
import pytest

from repro.distributed.compat import abstract_mesh as j_abstract_mesh
from repro.distributed.sharding import make_rules as j_make_rules, \
    spec_for as j_spec_for
from repro_torch.distributed.compat import abstract_mesh
from repro_torch.distributed.sharding import make_rules, spec_for

MESH = abstract_mesh((16, 16), ("data", "model"))
MESH3 = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
J_MESH = j_abstract_mesh((16, 16), ("data", "model"))
J_MESH3 = j_abstract_mesh((2, 16, 16), ("pod", "data", "model"))

CASES = {
    # (embed, mlp) weight: embed->data (FSDP), mlp->model (TP)
    "tp_and_fsdp_assignment": (
        ("embed", "mlp"), (4096, 14336), False, ("data", "model")),
    # (experts, embed, mlp): experts takes model first; mlp must not reuse
    "axis_used_once_per_array": (
        ("experts", "embed", "mlp"), (160, 5120, 1536), False,
        ("model", "data")),
    # 8 kv heads cannot shard 16 ways -> replicated
    "divisibility_fallback_heads": (
        ("kv_heads", "head_dim"), (8, 128), False, ()),
    # vocab not divisible by 16 -> falls through model AND data -> None
    "divisibility_fallback_vocab": (
        ("vocab", "embed"), (50280, 2048), False, (None, "data")),
    # batch=1 unshardable => seq gets data AND model (256-way)
    "seq_kv_takes_both_axes_when_batch_absent": (
        ("batch", "seq_kv", "kv_heads", "head_dim"), (1, 524288, 8, 128),
        False, (None, ("data", "model"))),
    "seq_kv_model_only_when_batch_holds_data": (
        ("batch", "seq_kv", "kv_heads", "head_dim"), (128, 32768, 8, 128),
        False, ("data", "model")),
    "multipod_batch_spans_pod_and_data": (
        ("batch", None, None), (256, 4096, 1), True, (("pod", "data"),)),
    # kv_lora is a contraction dim: it never takes the model axis
    "kv_lora_never_takes_model": (
        ("kv_lora", "q_heads", "head_dim"), (512, 128, 128), False,
        ("data", "model")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_for_matches_reference(case):
    axes, shape, multi_pod, want = CASES[case]
    rules, mesh = ((make_rules(True, fsdp=True), MESH3) if multi_pod
                   else (make_rules(False, fsdp=True), MESH))
    j_rules, j_mesh = ((j_make_rules(True, fsdp=True), J_MESH3)
                       if multi_pod else
                       (j_make_rules(False, fsdp=True), J_MESH))
    got = spec_for(axes, rules, mesh, shape)
    assert got == want
    assert got == tuple(j_spec_for(axes, j_rules, j_mesh, shape))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rule_tables_equal_the_reference(multi_pod):
    for fsdp in (False, True):
        assert make_rules(multi_pod, fsdp=fsdp) == \
            j_make_rules(multi_pod, fsdp=fsdp)


def test_tree_device_bytes_and_plane_batch_shardings():
    import torch
    from repro_torch.distributed.sharding import PSpec, \
        plane_batch_shardings, tree_device_bytes
    rules = make_rules(False)
    tree = {"w": PSpec(torch.empty((4096, 14336), dtype=torch.bfloat16,
                                   device="meta"), ("embed", "mlp")),
            "b": PSpec(torch.empty((8, 128), device="meta"),
                       ("kv_heads", "head_dim"))}
    assert tree_device_bytes(tree, MESH, rules) == \
        4096 * 14336 * 2 // 256 + 8 * 128 * 4
    mesh4 = abstract_mesh((4,), ("data",))
    batch = {"tokens": torch.empty((8, 16)), "pos": torch.empty(()),
             "odd": torch.empty((6,))}
    assert plane_batch_shardings(batch, mesh4) == {
        "tokens": (("data",),), "pos": (), "odd": ()}
    assert plane_batch_shardings({"t": torch.empty((3, 8, 16))}, mesh4,
                                 stacked=True) == {"t": (None, ("data",))}


def test_shardings_for_and_batch_shardings_follow_spec_for():
    import torch
    from repro_torch.distributed.sharding import PSpec, batch_shardings, \
        shardings_for
    rules = make_rules(False)
    tree = {"w": PSpec(torch.empty((4096, 14336), device="meta"),
                       ("embed", "mlp")),
            "kv": [PSpec(torch.empty((8, 128), device="meta"),
                         ("kv_heads", "head_dim"))]}
    assert shardings_for(tree, MESH, rules) == {
        "w": ("data", "model"), "kv": [()]}
    specs = {"tokens": torch.empty((256, 4096), device="meta"),
             "pos": torch.empty((), device="meta"),
             "one": torch.empty((1, 4096), device="meta")}
    assert batch_shardings(specs, MESH, rules) == {
        "tokens": ("data",), "pos": (), "one": ()}


def test_mesh_modules_import_neither_jax_nor_the_reference():
    """The mesh slice's modules and example stand alone, like the rest
    of the port (``test_torch_imports.py``'s rule)."""
    import ast
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    files = [root / "src" / "repro_torch" / rel for rel in (
        "distributed/compat.py", "distributed/meshctx.py",
        "distributed/sharding.py", "launch/mesh.py")]
    files.append(root / "examples" / "serve_specialized_torch.py")
    for path in files:
        roots = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert not {"jax", "jaxlib", "repro"} & roots, (path, roots)
    code = ("import sys, repro_torch.distributed.compat, "
            "repro_torch.distributed.sharding, repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
