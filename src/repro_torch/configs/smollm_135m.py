"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]  9 heads do not
divide the 16-way model axis: hybrid profile (TP on MLP, replicated
attention) — the dp-heavy baseline the §Perf log hillclimbs."""
from ..models.blocks import BlockSpec, ModelConfig
from .registry import ArchEntry, register


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", n_layers=30, d_model=576, n_heads=9,
        n_kv_heads=3, d_ff=1536, vocab_size=49152,
        pattern=(BlockSpec("attn"),), tie_embeddings=True,
        sharding_profile="hybrid")


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-reduced", n_layers=4, d_model=72, n_heads=9,
        n_kv_heads=3, d_ff=192, vocab_size=128,
        pattern=(BlockSpec("attn"),), tie_embeddings=True, remat=False,
        sharding_profile="hybrid")


register(ArchEntry("smollm-135m", "dense", config, reduced,
                   notes="9 heads indivisible by tp=16 -> hybrid profile"))
