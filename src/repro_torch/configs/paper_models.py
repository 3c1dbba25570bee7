"""The paper's evaluated DNN workloads (Fig. 1 / Fig. 11) as DORA
workload DAGs: MLP, DeiT, BERT, PointNet, NCF — each in -L (large) and
-S (small) versions, model sizes spanning ~0.8M to ~110M params, FP32.

Layer dims follow the papers cited in §6.3; these graphs feed the
two-stage DSE + scheduler + codegen pipeline and the baseline policy
models (CHARM-a/b, RSN).

Copy of ``repro.configs.paper_models`` with its imports pointed at the
port's ``core`` and config registry.
"""

from __future__ import annotations

from repro_torch.core.graph import NonLinear, WorkloadGraph, mlp_graph


def mlp_l() -> WorkloadGraph:
    # large, near-square MMs (3072 x 4096 x 4096) — the paper's
    # computation-bound low-variance workload
    return mlp_graph("MLP-L", 3072, [4096] * 5, NonLinear.RELU)


def mlp_s() -> WorkloadGraph:
    return mlp_graph("MLP-S", 256, [512] * 5, NonLinear.RELU)


def _vit(name: str, seq: int, d: int, ff: int, blocks: int) -> WorkloadGraph:
    from repro_torch.core.graph import transformer_block_graph
    g = WorkloadGraph(name)
    x = g.add_input("x", seq, d)
    for b in range(blocks):
        x = transformer_block_graph(g, f"b{b}", x, seq, d, d // 64, ff)
    return g


def deit_l() -> WorkloadGraph:
    # DeiT-Base: 197 tokens, d=768 — mixed large/small, non-aligned dims
    return _vit("DeiT-L", 197, 768, 3072, 4)


def deit_s() -> WorkloadGraph:
    # DeiT-Small: d=384
    return _vit("DeiT-S", 197, 384, 1536, 4)


def bert_l() -> WorkloadGraph:
    # BERT-Base shapes: seq 512, d=768
    return _vit("BERT-L", 512, 768, 3072, 4)


def bert_s() -> WorkloadGraph:
    # "BERT-32": tiny model, seq 32 — the paper's worst case for padding
    return _vit("BERT-S", 32, 256, 1024, 2)


def _pointnet(name: str, npoints: int) -> WorkloadGraph:
    # PointNet shared MLPs (1x1 conv == MM over points) + classifier FCs:
    # extremely diverse MM shapes incl. tall-skinny and tiny layers
    g = WorkloadGraph(name)
    x = g.add_input("pts", npoints, 16)       # xyz padded feature
    dims = [64, 64, 64, 128, 1024]
    for i, dn in enumerate(dims):
        w = g.add_input(f"w{i}", g._shape_of(x)[1], dn)
        x = g.add_mm(f"sm{i}", x, w, NonLinear.RELU)
    # global feature -> classifier tower (batch 1 rows)
    gf = g.add_input("gfeat", 16, 1024)       # pooled features (batch 16)
    dims2 = [512, 256, 40]
    y = gf
    for i, dn in enumerate(dims2):
        w = g.add_input(f"fc{i}", g._shape_of(y)[1], dn)
        y = g.add_mm(f"cls{i}", y, w,
                     NonLinear.RELU if i < len(dims2) - 1 else None)
    return g


def pointnet_l() -> WorkloadGraph:
    return _pointnet("PointNet-L", 4096)


def pointnet_s() -> WorkloadGraph:
    return _pointnet("PointNet-S", 1024)


def _ncf(name: str, batch: int, embed: int) -> WorkloadGraph:
    # NCF MLP tower, diverse shapes down to (batch x 32 x 1)
    g = WorkloadGraph(name)
    x = g.add_input("uv", batch, embed)
    dims = [embed // 2, embed // 4, 32, 1]
    for i, dn in enumerate(dims):
        w = g.add_input(f"w{i}", g._shape_of(x)[1], dn)
        x = g.add_mm(f"fc{i}", x, w,
                     NonLinear.RELU if i < len(dims) - 1 else None)
    return g


def ncf_l() -> WorkloadGraph:
    return _ncf("NCF-L", 3072, 512)


def ncf_s() -> WorkloadGraph:
    return _ncf("NCF-S", 1024, 128)


def from_arch(arch: str, seq: int = 256,
              blocks: int | None = None) -> WorkloadGraph:
    """One of the repo's model configs (configs/__init__.py registry) as
    a DORA workload DAG: each transformer block becomes the MM/NL layer
    group of ``transformer_block_graph``.  ``blocks`` caps the block
    count (None = the config's full depth; whisper-style enc-dec counts
    encoder + decoder blocks).  Only attention+FFN architectures map;
    SSM/conv-dominated configs are rejected up front."""
    from repro_torch.configs import get_config
    from repro_torch.core.graph import transformer_block_graph

    cfg = get_config(arch)
    if cfg.d_ff <= 0 or cfg.n_heads <= 0:
        raise ValueError(
            f"{arch}: from_arch only maps attention+FFN blocks "
            f"(needs d_ff > 0 and n_heads > 0, got d_ff={cfg.d_ff}, "
            f"n_heads={cfg.n_heads})")
    n_blocks = cfg.n_layers + cfg.encoder_layers
    if blocks is not None:
        n_blocks = min(n_blocks, blocks)
    g = WorkloadGraph(f"{cfg.name}-w{seq}")
    x = g.add_input("x", seq, cfg.d_model)
    for b in range(n_blocks):
        x = transformer_block_graph(g, f"b{b}", x, seq, cfg.d_model,
                                    cfg.n_heads, cfg.d_ff)
    return g


ALL = {
    "MLP-L": mlp_l, "MLP-S": mlp_s,
    "DeiT-L": deit_l, "DeiT-S": deit_s,
    "BERT-L": bert_l, "BERT-S": bert_s,
    "PointNet-L": pointnet_l, "PointNet-S": pointnet_s,
    "NCF-L": ncf_l, "NCF-S": ncf_s,
}


def get(name: str) -> WorkloadGraph:
    return ALL[name]()
