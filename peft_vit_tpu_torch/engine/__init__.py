from .serving import ServingSession, make_infer_fn

__all__ = ["ServingSession", "make_infer_fn"]
