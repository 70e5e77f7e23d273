from .manifests import load_garment_categories

__all__ = ["load_garment_categories"]
