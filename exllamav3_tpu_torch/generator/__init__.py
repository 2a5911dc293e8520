from .generator import Generator
from .job import Job
from .sampler import CustomSampler, DefaultSampler, GreedySampler, Sampler
