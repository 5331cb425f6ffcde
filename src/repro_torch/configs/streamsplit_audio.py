"""The paper's own model: ResNet-18-1D audio encoder, L=8 split blocks,
d=128 embeddings (§5 Reproducibility Details)."""
from repro_torch.models.audio_encoder import AudioEncCfg

CFG = AudioEncCfg()
