from .classification import ClassificationTask
from .task import TrainingTask
