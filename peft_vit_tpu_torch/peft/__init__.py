from .spec import PEFTSpec

__all__ = ["PEFTSpec"]
