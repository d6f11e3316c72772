"""The paper's algorithmic pieces on resident tensors."""
