from .work import WorkType, WorkRequest, WorkResult  # noqa: F401
