"""YuNet as nn.Modules, and the BN-folded fused forward."""
