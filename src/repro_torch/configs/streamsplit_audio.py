"""The paper's own model: ResNet-18-1D audio encoder, L=8 split blocks,
d=128 embeddings, GMM C=64 (§5 Reproducibility Details)."""
from dataclasses import dataclass

from repro_torch.configs import base as _base
from repro_torch.models.audio_encoder import AudioEncCfg

CFG = AudioEncCfg()


@dataclass(frozen=True)
class _AudioMarker:
    """Registry marker, as in the reference: ``get_config`` finds the
    audio model by name; a walk of the registry for LM configs skips
    ``family == "audio_enc"``."""
    name: str = CFG.name
    family: str = CFG.family
    hybrid_period: int = 0


_base._REGISTRY[CFG.name] = _AudioMarker()
