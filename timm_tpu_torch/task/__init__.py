from .classification import ClassificationTask, NaFlexClassificationTask
from .task import Normalize, TrainingTask
