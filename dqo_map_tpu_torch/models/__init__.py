from .cameras import Camera  # noqa: F401
