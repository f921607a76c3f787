"""Ask/tell designer interfaces."""
