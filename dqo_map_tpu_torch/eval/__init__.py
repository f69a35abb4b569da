from .evaluate import eval_frame, eval_picture  # noqa: F401
