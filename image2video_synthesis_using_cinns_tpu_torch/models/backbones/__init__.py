from .lpips import LPIPS
from .vgg16 import VGG16Features

__all__ = ["VGG16Features", "LPIPS"]
