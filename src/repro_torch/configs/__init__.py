"""The paper's model profiles."""
