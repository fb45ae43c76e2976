from .recipes import flagship_fast
