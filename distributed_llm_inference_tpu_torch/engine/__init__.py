from .engine import InferenceEngine
from .sampling import SamplingOptions, SamplingParams, sample
from .session import Session, SessionState

__all__ = [
    "InferenceEngine",
    "SamplingOptions",
    "SamplingParams",
    "sample",
    "Session",
    "SessionState",
]
