from .stats import PipelineStats  # noqa: F401
