"""The paper's own evaluation models (``repro.configs.paper_models`` in
torch): W&D, DLRM, DIN, MMoE and CAN (Tab. II).

Not registered as archs, as in the reference: callers build the config
directly (``dlrm()`` at full width, ``din(scale=0.01)`` as the reference's
throughput bench trains it); ``PAPER_MODELS`` maps each name to the
function that makes its config. ``scale < 1`` gives the CPU-sized siblings.
"""
from repro_torch.configs.base import FeatureField, InteractionSpec, WDLConfig
from repro_torch.configs.criteo import CRITEO_VOCABS, N_DENSE


def _seq_fields(prefix, n, vocab, dim, max_len, group):
    return [
        FeatureField(f"{prefix}_{i}", vocab=vocab, dim=dim, max_len=max_len, pooling="sum", group=group)
        for i in range(n)
    ]


def widedeep(scale: float = 1.0, dims=(8, 16, 32)) -> WDLConfig:
    """W&D on Product-1: 10 numeric + 204 sparse fields, emb dims 8~32."""
    n = max(1, int(204 * scale))
    fields = []
    for i in range(n):
        dim = dims[i % len(dims)]
        vocab = int((10_000 + 997 * i * 31) * max(scale, 0.01)) + 64
        fields.append(FeatureField(f"f{i}", vocab=vocab, dim=dim, max_len=1, pooling="sum"))
    return WDLConfig(
        name="widedeep",
        fields=tuple(fields),
        n_dense=10,
        interactions=(InteractionSpec("linear"),),
        mlp_dims=(512, 256, 128) if scale >= 1 else (32, 16),
    )


def dlrm(criteo: bool = True, scale: float = 1.0) -> WDLConfig:
    """DLRM on Criteo, emb dim 128 (Tab. II)."""
    if criteo and scale >= 1:
        vocabs = CRITEO_VOCABS
        dim, mlp, bot = 128, (1024, 1024, 512, 256), (512, 256, 128)
    else:
        vocabs = tuple(int(500 + 61 * i) for i in range(26))
        dim, mlp, bot = 16, (64, 32), (32, 16)
    fields = tuple(
        FeatureField(f"cat_{i}", vocab=int(v), dim=dim, max_len=1, pooling="sum") for i, v in enumerate(vocabs)
    )
    return WDLConfig(
        name="dlrm",
        fields=fields,
        n_dense=N_DENSE,
        interactions=(InteractionSpec("dot"),),
        mlp_dims=mlp,
        dense_arch=bot,
    )


def din(scale: float = 1.0) -> WDLConfig:
    """DIN on Alibaba: 1207 fields = 7 one-hot + 12 behaviour seqs x ~100, dim 4."""
    big = scale >= 1
    n_seq = 12 if big else 3
    seq_len = 100 if big else 8
    vocab = 2_000_000 if big else 3000
    dim = 4 if big else 8
    fields = [FeatureField(f"prof_{i}", vocab=10_000 if big else 500, dim=dim) for i in range(7)]
    for i in range(n_seq):
        fields.append(
            FeatureField(f"hist_{i}", vocab=vocab, dim=dim, max_len=seq_len, pooling="none", group="seq")
        )
    fields.append(FeatureField("target_item", vocab=vocab, dim=dim, group="target", shared_table="hist_0"))
    return WDLConfig(
        name="din",
        fields=tuple(fields),
        n_dense=0,
        interactions=(
            InteractionSpec("target_attn", fields=tuple(f"hist_{i}" for i in range(n_seq)) + ("target_item",),
                            kwargs={"seq_len": seq_len}),
        ),
        mlp_dims=(200, 80) if big else (32, 16),
    )


def mmoe(scale: float = 1.0) -> WDLConfig:
    """MMoE variant of §II-D: 94 fields (84 one-hot + 10 seqs x 50), 71 experts."""
    big = scale >= 1
    n_onehot, n_seq, seq_len = (84, 10, 50) if big else (12, 2, 6)
    n_experts, n_tasks = (71, 4) if big else (5, 2)
    dims = (12, 32, 64, 128) if big else (8, 16)
    fields = [
        FeatureField(f"f{i}", vocab=(50_000 if big else 700) + 13 * i, dim=dims[i % len(dims)])
        for i in range(n_onehot)
    ]
    fields += _seq_fields("hist", n_seq, 1_000_000 if big else 900, dims[0], seq_len, "seq")
    return WDLConfig(
        name="mmoe",
        fields=tuple(fields),
        n_dense=0,
        interactions=(InteractionSpec("mmoe", kwargs={"n_experts": n_experts, "expert_dim": 256 if big else 16}),),
        mlp_dims=(512, 256) if big else (16,),
        n_tasks=n_tasks,
    )


def can(scale: float = 1.0) -> WDLConfig:
    """CAN on Product-2: 1834 fields = 334 one-hot + 30 seqs x 50, dims 8~200."""
    big = scale >= 1
    n_onehot, n_seq, seq_len = (334, 30, 50) if big else (10, 3, 6)
    dims = (8, 16, 64, 200) if big else (8, 16)
    fields = [
        FeatureField(f"f{i}", vocab=(100_000 if big else 800) + 17 * i, dim=dims[i % len(dims)])
        for i in range(n_onehot)
    ]
    for i in range(n_seq):
        fields.append(
            FeatureField(f"hist_{i}", vocab=5_000_000 if big else 1200, dim=dims[0],
                         max_len=seq_len, pooling="none", group="seq")
        )
    fields.append(FeatureField("target_item", vocab=5_000_000 if big else 1200, dim=dims[0],
                               group="target", shared_table="hist_0"))
    # CAN = co-action (target x history MLP-as-weights) + DIN-style attention branches
    return WDLConfig(
        name="can",
        fields=tuple(fields),
        n_dense=0,
        interactions=(
            InteractionSpec("target_attn", fields=tuple(f"hist_{i}" for i in range(n_seq)) + ("target_item",),
                            kwargs={"seq_len": seq_len}),
            InteractionSpec("coaction", fields=("hist_0", "target_item"), kwargs={"seq_len": seq_len}),
        ),
        mlp_dims=(512, 256, 128) if big else (32, 16),
    )


PAPER_MODELS = {"widedeep": widedeep, "dlrm": dlrm, "din": din, "mmoe": mmoe, "can": can}
