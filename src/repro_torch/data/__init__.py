from repro_torch.data.pipeline import DataConfig, SyntheticTokens, batches_for_arch

__all__ = ["DataConfig", "SyntheticTokens", "batches_for_arch"]
