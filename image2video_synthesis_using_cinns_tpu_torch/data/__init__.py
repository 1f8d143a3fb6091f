from .registry import get_eval_loader, get_loader

__all__ = ["get_loader", "get_eval_loader"]
