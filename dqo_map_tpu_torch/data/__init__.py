from .readers import Dataset  # noqa: F401
