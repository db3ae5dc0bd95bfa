"""`python -m fwav` == the compress/decompress CLI."""

from .cli import main

main()
