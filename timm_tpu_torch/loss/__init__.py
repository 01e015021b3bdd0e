from .cross_entropy import LabelSmoothingCrossEntropy, SoftTargetCrossEntropy, cross_entropy
from .jsd import JsdCrossEntropy
