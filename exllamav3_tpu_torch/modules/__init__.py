from .module import ForwardCtx, Module
from .linear import Linear
from .embedding import Embedding
from .norms import RMSNorm
from .attn import Attention
from .mlp import GatedMLP
from .transformer import TransformerBlock
