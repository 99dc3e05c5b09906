"""Models of the port: the decoder zoo (dense GQA/MQA, sliding-window and
local:global, MoE with shared experts, MLA, RG-LRU hybrid, VLM) behind one
ModelConfig and the Model facade."""
from .config import ModelConfig
from .model import Model, build_model, cross_entropy
