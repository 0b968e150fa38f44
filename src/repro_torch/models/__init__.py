"""The paper's MLP, torch form."""
