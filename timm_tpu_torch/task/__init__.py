from .classification import ClassificationTask
from .task import Normalize, TrainingTask
