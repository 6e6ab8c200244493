"""Models of the port: the GPT family, its decode path and the converter
from the JAX package's parameter trees."""
