from .model import SSD, ExtraBlock, VGG16Features, build_ssd

__all__ = ["SSD", "ExtraBlock", "VGG16Features", "build_ssd"]
