from .work import WorkType, WorkRequest, WorkResult, DifficultyModel  # noqa: F401
