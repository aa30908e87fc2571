from .io import load_embedding, load_embedding_dir, save_embedding

__all__ = ["save_embedding", "load_embedding", "load_embedding_dir"]
